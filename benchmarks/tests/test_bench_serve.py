"""The serve driver end to end at a tiny size on the CPU: the port's
runtime, Serve, the engine and the generator, the closed loop, the window,
the readers and the comparison; the comparison fails on a broken step; the
plain reference against the port; and the control."""

import json

import numpy as np
import pytest
import torch

from benchmarks import run as run_mod
from benchmarks.drivers import serve
from benchmarks.drivers.serve_generator import BenchGenerator
from benchmarks.tests import tiny

CELL = tiny.cell("tiny.serve", tiny.LLAMA, tiny.SERVE_MIX,
                 tiny.SERVE_LIMITS)
SEED = 2 ** 33 + 101


def _line(fig, trace=False):
    fig["probes"][0]["device"] = "cpu"
    return run_mod.result_line(CELL, fig, trace)


def test_serve_run_is_correct():
    fig = serve.run(CELL, SEED, 3.0, trace=True, device="cpu")
    line = _line(fig, trace=True)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks"
    names = set(line["metrics"])
    assert {"engine_step_ms.serve", "slot_fill.serve",
            "mfu.serve"} <= names
    assert 0 < line["metrics"]["slot_fill.serve"]["value"] <= 100
    assert fig["compared"]["tokens_compared"] >= 3 * 6
    # no device trace on the CPU: a traced card run that read this little
    # would print no result
    assert run_mod.missing_metrics(CELL, line) == ["device_idle.serve"]
    line["device"].pop("busy_s")
    assert run_mod.missing_metrics(CELL, line)[-1] == "busy_s"
    e2e = fig["end_to_end"]
    assert e2e["serve_tok_s"] > 0 and e2e["itl_p95_ms"] > 0
    assert 0 < e2e["setup_s"] < 300
    json.dumps(line)


def test_serve_altered_token_is_not_correct():
    class AlteredToken(BenchGenerator):
        """Each emitted token moved by one where it is produced."""

        def _step(self, model_id, states):
            out = BenchGenerator._step(self, model_id, states)
            res = []
            for s, r in zip(states, out):
                if r is None:
                    res.append(None)
                    continue
                bad = (r[0] + 1) % self._cfg.vocab_size
                s["tokens"][-1] = bad
                res.append((bad, r[1]))
            return res

    fig = serve.run(CELL, SEED, 2.0, trace=False, device="cpu",
                    gen_cls=AlteredToken)
    assert not _line(fig)["correct"]


def test_serve_step_without_the_model_is_not_correct():
    class StaleStep(BenchGenerator):
        """A step that leaves the state as it was: emits the last token
        again without running the model."""

        def _step(self, model_id, states):
            res = []
            for s in states:
                if s is None:
                    res.append(None)
                    continue
                tok = s["tokens"][-1]
                s["tokens"].append(tok)
                res.append((tok, len(s["tokens"]) - s["prompt_len"]
                            >= s["max_new"]))
            return res

    fig = serve.run(CELL, SEED, 2.0, trace=False, device="cpu",
                    gen_cls=StaleStep)
    assert not _line(fig)["correct"]


def _inprocess_sample(seed, dtype=torch.bfloat16):
    """Greedy generations of the port's LlamaGenerator, in process."""
    from benchmarks.drivers.serve import llama_config
    from benchmarks.harness import sizes

    c = sizes(tiny.LLAMA)
    gen = BenchGenerator(config=llama_config(c, dtype),
                         lora_rank=2, max_batch_size=4,
                         allowed_batch_sizes=(1, 2, 4), max_new_tokens=24,
                         seq_bucket=32, seed=seed, device="cpu")
    try:
        rng = np.random.default_rng(seed)
        sample = []
        for i in range(4):
            p = rng.integers(0, c["vocab_size"], 40).tolist()
            toks = list(gen({"prompt": p, "max_new": 24, "adapter": "a0"}))
            sample.append({"prompt": p, "tokens": toks, "adapter": "a0"})
    finally:
        gen.engine.shutdown()
    return c, sample


@pytest.mark.parametrize("seed", [7, 2 ** 33 + 3])
def test_reference_against_port_and_control(seed):
    c, sample = _inprocess_sample(seed)
    prog = serve.compare(sample, c, seed, 2, "cpu")
    ctl = serve.compare(sample, c, seed, 2, "cpu", quant="fp8")
    limit = tiny.SERVE_LIMITS["max_gap"]["limit"]
    assert prog["max_gap"] <= limit / 2, prog
    assert ctl["max_gap"] > limit, ctl


def test_reference_is_the_port_in_float32():
    """With float32 weights and products the port's served tokens are the
    reference's best at every position."""
    c, sample = _inprocess_sample(11, torch.float32)
    got = serve.compare(sample, c, 11, 2, "cpu", dtype="float32")
    assert got["max_gap"] == 0.0 and got["positions"] == 4 * 24, got


@pytest.mark.card
def test_control_at_the_cells_size(card):
    """On the card: the control fails the cell's limit on three seeds that
    the program passes."""
    from benchmarks import control, harness

    cell = harness.resolve_cell("mistral-7b.serve-chat")
    limit = cell.limits["max_gap"]["limit"]
    for seed in (2 ** 33 + 11, 2 ** 33 + 12, 2 ** 33 + 13):
        r = control.readings(cell, seed, 15.0)
        assert r["program"]["max_gap"] <= limit, r
        assert r["control"]["max_gap"] > limit, r
