"""The train driver end to end at a tiny size on the CPU: the port's
runtime, ``TorchTrainer`` with one worker, the MoE's train step, the window,
the readers and the comparison with the plain reference; the comparison
fails on a step that leaves the state unchanged and on a step that drops
half the batch; and the fp8 control fails it."""

import pytest

from benchmarks import run as run_mod
from benchmarks.drivers import train
from benchmarks.tests import tiny

SFT = tiny.cell("tiny.sft", tiny.MOE, tiny.SFT_MIX, tiny.SFT_LIMITS)
ONE_ROW = tiny.cell("tiny.sft-one-row", tiny.MOE,
                    dict(tiny.SFT_MIX, batch=1, seq=64), tiny.SFT_LIMITS)
SEED = 2 ** 33 + 202


def _line(cell, fig, trace=False):
    fig["probes"][0]["device"] = "cpu"
    return run_mod.result_line(cell, fig, trace)


def test_train_run_is_correct():
    fig = train.run(SFT, SEED, 2.0, trace=True, device="cpu")
    line = _line(SFT, fig, trace=True)
    assert line["correct"], (line["checks"], fig["compared"])
    assert line["attempted"] == fig["readings"]["steps"] > 0
    assert "mfu.train" in line["metrics"]
    assert fig["end_to_end"]["train_tok_s"] > 0
    assert list(line)[-1] == "checks"


def _faulty_loop(fault):
    def loop(config):
        from benchmarks.drivers import train_loop as tl

        build = tl.build

        def faulty_build(config, dev):
            step, state = build(config, dev)
            if fault == "unchanged":
                state.opt_state.step = lambda closure=None: None
                return step, state
            return train.half_batch(step), state

        tl.build = faulty_build
        try:
            tl.train_loop(config)
        finally:
            tl.build = build
    return loop


@pytest.mark.parametrize("cell,fault", [
    (SFT, "unchanged"), (SFT, "half_batch"), (ONE_ROW, "half_batch")],
    ids=["unchanged", "half-batch", "half-batch-one-row"])
def test_faults_are_not_correct(cell, fault):
    fig = train.run(cell, SEED, 1.0, trace=False, device="cpu",
                    loop=_faulty_loop(fault))
    assert not _line(cell, fig)["correct"], fig["compared"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_control_plants_the_faults(fault):
    """``control.readings`` plants each fault in the program's steps in
    process, and the fault fails the limits."""
    from benchmarks import control

    r = control.readings(SFT, SEED, 1.0, device="cpu", fault=fault)
    assert not run_mod.judge(r["program"], SFT.limits)[0], r


@pytest.mark.parametrize("cell", [SFT, ONE_ROW], ids=["sft", "one-row"])
def test_program_passes_and_control_fails(cell):
    """The port's compared steps in process pass the limits, and the plain
    reference computed in fp8 fails them, both against the float32
    reference on the program's routing."""
    config = train.loop_config(cell, SEED, 1.0, False, "cpu")
    prog = train.program_readings(config, "cpu")
    routing = prog.get("routing")
    want = train.reference_readings(config, "cpu", routing=routing)
    assert run_mod.judge(train.compare(prog, want), cell.limits)[0]
    ctl = train.compare(train.reference_readings(
        config, "cpu", quant="fp8", routing=routing), want)
    ok, _ = run_mod.judge(ctl, cell.limits)
    assert not ok, ctl


@pytest.mark.parametrize("cell", [SFT, ONE_ROW], ids=["sft", "one-row"])
def test_reference_is_the_port_in_float32(cell):
    """In float32 the port's compared steps and the plain reference's agree
    to float32 rounding: losses, first gradients and changes."""
    import copy

    conf = copy.deepcopy(cell.config)
    conf["config"]["torch_dtype"] = "float32"
    config = train.loop_config(tiny.cell(cell.name, conf, cell.traffic, {}),
                               SEED, 1.0, False, "cpu")
    prog = train.program_readings(config, "cpu")
    got = train.compare(prog, train.reference_readings(
        config, "cpu", routing=prog.get("routing")))
    assert got["loss_gap"] < 1e-6, got
    assert got["grad_gap"] < 1e-5 and got["change_gap"] < 1e-5, got
    assert got["route_disagree"] == 0.0, got
    assert got["route1_disagree"] == 0.0, got


@pytest.mark.card
def test_control_at_the_cells_size(card):
    """On the card: the program passes the cell's limits and the fp8
    reference fails them on three seeds, against the float32 reference on
    the same batches."""
    from benchmarks import control, harness

    cell = harness.resolve_cell("mixtral-8x7b-d2.train-sft")

    for seed in (2 ** 33 + 21, 2 ** 33 + 22, 2 ** 33 + 23):
        r = control.readings(cell, seed, 1.0)
        assert run_mod.judge(r["program"], cell.limits)[0], r
        assert not run_mod.judge(r["control"], cell.limits)[0], r
