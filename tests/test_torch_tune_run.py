"""ray_tpu_torch's Tune on the port's runtime, on the CPU: the JAX
package's runtime Tune tests (``tests/test_tune.py``'s ten) to the same
expectations, a ``Tuner(TorchTrainer)`` sweep of the tiny Llama LoRA step
over two learning rates against the JAX package's train step at each,
trial actors that share one GPU id (``{"GPU": 0.5}``), and the package's
imports. ``tests/test_torch_tune_extras_run.py`` holds the rest.

One port cluster per module, ``init(num_cpus=4, resources={"GPU": 1})`` as
``tests/test_torch_train.py`` boots it (one GPU id with no card behind it).
Trainables are defined inside the tests, so that they travel by value and
no worker imports this module (and with it jax). A trial iteration has a
deadline of 120 s (``RAY_TPU_TORCH_TUNE_RESULT_TIMEOUT_S``) and a Train
result round too, so that a wedged trial fails its test instead of holding
the run."""

import json
import os
import subprocess
import sys
import time

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import pytest  # noqa: E402

import ray_tpu_torch  # noqa: E402
from ray_tpu_torch import tune  # noqa: E402
from ray_tpu_torch.air.config import (  # noqa: E402
    FailureConfig, RunConfig)
from ray_tpu_torch.tune import TuneConfig, Tuner  # noqa: E402
from ray_tpu_torch.tune.schedulers import (  # noqa: E402
    ASHAScheduler, MedianStoppingRule, PopulationBasedTraining)
from tests.test_torch_runtime import port_session_leak_check  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINES = {"RAY_TPU_TORCH_TUNE_RESULT_TIMEOUT_S": "120",
             "RAY_TPU_TORCH_TRAIN_RESULT_TIMEOUT_S": "120"}


@pytest.fixture(scope="module")
def port_cluster():
    old = {k: os.environ.get(k) for k in DEADLINES}
    os.environ.update(DEADLINES)
    ray_tpu_torch.init(num_cpus=4, resources={"GPU": 1})
    session_dir = ray_tpu_torch._global_node.session_dir
    yield session_dir
    ray_tpu_torch.shutdown()
    for k, v in old.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    port_session_leak_check(session_dir)


# --------------------------------------------- tests/test_tune.py's sweeps

def test_function_trainable_sweep(port_cluster, tmp_path):
    def objective(config):
        from ray_tpu_torch import tune

        for i in range(3):
            tune.report({"loss": config["x"] ** 2 + i * 0.01})

    results = Tuner(
        objective,
        param_space={"x": tune.grid_search([-2.0, -1.0, 0.0, 1.0])},
        tune_config=TuneConfig(metric="loss", mode="min"),
        run_config=RunConfig(name="sweep", storage_path=str(tmp_path)),
    ).fit()
    assert len(results) == 4
    assert results.num_errors == 0
    assert results.get_best_result().metrics["loss"] == pytest.approx(0.02)
    assert os.path.exists(
        os.path.join(tmp_path, "sweep", "experiment_state.json"))


def test_class_trainable(port_cluster, tmp_path):
    class MyTrainable(tune.Trainable):
        def setup(self, config):
            self.acc = 0.0

        def step(self):
            self.acc += self.config["rate"]
            return {"acc": self.acc, "done": self.acc >= 1.0}

        def save_checkpoint(self, d):
            with open(os.path.join(d, "state.json"), "w") as f:
                json.dump({"acc": self.acc}, f)

        def load_checkpoint(self, d):
            with open(os.path.join(d, "state.json")) as f:
                self.acc = json.load(f)["acc"]

    results = Tuner(
        MyTrainable,
        param_space={"rate": tune.grid_search([0.5, 0.25])},
        tune_config=TuneConfig(metric="acc", mode="max"),
        run_config=RunConfig(name="cls", storage_path=str(tmp_path)),
    ).fit()
    assert len(results) == 2
    assert results.num_errors == 0
    assert sorted(r.metrics["training_iteration"] for r in results) == [2, 4]


def test_stop_criteria(port_cluster, tmp_path):
    def objective(config):
        from ray_tpu_torch import tune

        for i in range(100):
            tune.report({"score": i})

    results = Tuner(
        objective, param_space={},
        run_config=RunConfig(name="stop", storage_path=str(tmp_path),
                             stop={"score": 5}),
    ).fit()
    assert results[0].metrics["score"] == 5


def test_asha_early_stops(port_cluster, tmp_path):
    def objective(config):
        import time

        from ray_tpu_torch import tune

        for i in range(20):
            # good trials report fast and reach the rungs first, so the
            # laggards meet a populated cutoff
            time.sleep(0.005 if config["q"] > 0.5 else 0.03)
            tune.report({"reward": config["q"] * (i + 1)})

    results = Tuner(
        objective,
        param_space={"q": tune.grid_search([0.1, 0.2, 1.0, 2.0])},
        tune_config=TuneConfig(
            metric="reward", mode="max", max_concurrent_trials=4,
            scheduler=ASHAScheduler(max_t=20, grace_period=2,
                                    reduction_factor=2)),
        run_config=RunConfig(name="asha", storage_path=str(tmp_path)),
    ).fit()
    iters = sorted(r.metrics["training_iteration"] for r in results)
    assert iters[0] < 20          # at least one trial stopped early
    assert iters[-1] == 20        # the best ran to max_t
    assert results.get_best_result().metrics["reward"] == pytest.approx(40.0)


def test_fault_tolerance_retries_from_checkpoint(port_cluster, tmp_path):
    marker = str(tmp_path / "fail_once")

    def objective(config):
        import os
        import tempfile

        from ray_tpu_torch import tune
        from ray_tpu_torch.train import Checkpoint

        start = 0
        ckpt = tune.get_checkpoint()
        if ckpt is not None:
            with open(os.path.join(ckpt.path, "it.txt")) as f:
                start = int(f.read()) + 1
        for i in range(start, 6):
            if i == 3 and not os.path.exists(config["marker"]):
                open(config["marker"], "w").close()
                raise RuntimeError("injected failure")
            with tempfile.TemporaryDirectory() as d:
                with open(os.path.join(d, "it.txt"), "w") as f:
                    f.write(str(i))
                tune.report({"i": i}, checkpoint=Checkpoint(d))

    results = Tuner(
        objective, param_space={"marker": marker},
        run_config=RunConfig(name="ft", storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=2)),
    ).fit()
    assert results.num_errors == 0
    assert results[0].metrics["i"] == 5
    assert os.path.exists(marker)


def test_failed_trial_reports_error(port_cluster, tmp_path):
    def objective(config):
        raise ValueError("boom")

    results = Tuner(
        objective, param_space={},
        run_config=RunConfig(name="err", storage_path=str(tmp_path)),
    ).fit()
    assert results.num_errors == 1
    assert "boom" in str(results.errors[0])


def test_pbt_runs_and_perturbs(port_cluster, tmp_path):
    def objective(config):
        import os
        import tempfile

        from ray_tpu_torch import tune
        from ray_tpu_torch.train import Checkpoint

        score = 0.0
        ckpt = tune.get_checkpoint()
        if ckpt is not None:
            with open(os.path.join(ckpt.path, "s.txt")) as f:
                score = float(f.read())
        for _ in range(12):
            score += config["lr"]
            with tempfile.TemporaryDirectory() as d:
                with open(os.path.join(d, "s.txt"), "w") as f:
                    f.write(str(score))
                tune.report({"score": score}, checkpoint=Checkpoint(d))

    pbt = PopulationBasedTraining(
        time_attr="training_iteration", perturbation_interval=3,
        hyperparam_mutations={"lr": tune.uniform(0.1, 1.0)}, seed=7)
    results = Tuner(
        objective,
        param_space={"lr": tune.uniform(0.1, 1.0)},
        tune_config=TuneConfig(metric="score", mode="max", num_samples=4,
                               max_concurrent_trials=4, scheduler=pbt,
                               seed=3),
        run_config=RunConfig(name="pbt", storage_path=str(tmp_path)),
    ).fit()
    assert results.num_errors == 0
    assert len(results) == 4
    assert all(r.metrics["score"] > 0 for r in results)


def test_median_stopping(port_cluster, tmp_path):
    """The rule stops the ``v=0.0`` trial only once two other trials have
    reported: each trial waits (up to 60 s) until all four have started,
    and paces its reports, so that the trials overlap under load too."""
    started = tmp_path / "started"
    started.mkdir()

    def objective(config):
        import os
        import time
        import uuid

        from ray_tpu_torch import tune

        d = config["started"]
        open(os.path.join(d, uuid.uuid4().hex), "w").close()
        deadline = time.monotonic() + 60
        while len(os.listdir(d)) < 4 and time.monotonic() < deadline:
            time.sleep(0.02)
        for _ in range(15):
            time.sleep(0.05)
            tune.report({"m": config["v"]})

    results = Tuner(
        objective,
        param_space={"v": tune.grid_search([1.0, 1.0, 1.0, 0.0]),
                     "started": str(started)},
        tune_config=TuneConfig(
            metric="m", mode="max", max_concurrent_trials=4,
            scheduler=MedianStoppingRule(grace_period=3,
                                         min_samples_required=2)),
        run_config=RunConfig(name="med", storage_path=str(tmp_path)),
    ).fit()
    assert min(r.metrics["training_iteration"] for r in results) < 15


def test_tuner_restore_resumes_unfinished(port_cluster, tmp_path):
    def objective(config):
        import os
        import tempfile

        from ray_tpu_torch import tune
        from ray_tpu_torch.train import Checkpoint

        start = 0
        ckpt = tune.get_checkpoint()
        if ckpt is not None:
            with open(os.path.join(ckpt.path, "it.txt")) as f:
                start = int(f.read()) + 1
        for i in range(start, 4):
            with tempfile.TemporaryDirectory() as d:
                with open(os.path.join(d, "it.txt"), "w") as f:
                    f.write(str(i))
                tune.report({"i": i}, checkpoint=Checkpoint(d))

    exp_dir = str(tmp_path / "resume")
    results = Tuner(
        objective, param_space={"x": tune.grid_search([1, 2])},
        run_config=RunConfig(name="resume", storage_path=str(tmp_path)),
    ).fit()
    assert all(r.metrics["i"] == 3 for r in results)

    # an interrupted run: one trial marked as mid-flight
    state_file = os.path.join(exp_dir, "experiment_state.json")
    with open(state_file) as f:
        state = json.load(f)
    state["trials"][0]["status"] = "RUNNING"
    with open(state_file, "w") as f:
        json.dump(state, f)

    assert Tuner.can_restore(exp_dir)
    results2 = Tuner.restore(exp_dir, objective).fit()
    assert len(results2) == 2
    assert all(r.metrics["i"] == 3 for r in results2)


def test_tune_wraps_trainer(port_cluster, tmp_path):
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer

    def loop(config):
        from ray_tpu_torch import train

        val = 0.0
        for _ in range(3):
            val += config["inc"]
            train.report({"val": val})

    trainer = TorchTrainer(
        loop, train_loop_config={"inc": 0.0},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False))
    results = Tuner(
        trainer,
        param_space={"train_loop_config": {
            "inc": tune.grid_search([1.0, 2.0])}},
        tune_config=TuneConfig(metric="val", mode="max",
                               max_concurrent_trials=1),
        run_config=RunConfig(name="trainer_sweep",
                             storage_path=str(tmp_path)),
    ).fit()
    assert results.num_errors == 0
    assert results.get_best_result().metrics["val"] == pytest.approx(6.0)


def _wait_all_free(limit_s=15.0):
    """Every resource of the cluster is free again within ``limit_s``."""
    deadline = time.monotonic() + limit_s
    while True:
        total = ray_tpu_torch.cluster_resources()
        avail = ray_tpu_torch.available_resources()
        busy = {k: (avail.get(k), v) for k, v in total.items()
                if k in ("CPU", "GPU") and avail.get(k) != v}
        if not busy:
            return
        assert time.monotonic() < deadline, f"still held: {busy}"
        time.sleep(0.1)


def test_trainer_trials_give_their_resources_back(port_cluster, tmp_path):
    """A trainer trial that its scheduler stops, or that reaches its end,
    unwinds its trainer before its actor is killed: the worker group shuts
    down and its placement group goes, so that after a sweep in which ASHA
    stops two of three trials every CPU and the GPU id are free again (the
    JAX package kills the actor first and the group's bundle stays held:
    ROADMAP Queue 3)."""
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer

    def loop(config):
        from ray_tpu_torch import train

        for i in range(4):
            train.report({"val": config["q"] * (i + 1)})

    grid = Tuner(
        TorchTrainer(loop, train_loop_config={"q": 0.0},
                     scaling_config=ScalingConfig(num_workers=1,
                                                  use_gpu=False)),
        param_space={"train_loop_config": {
            "q": tune.grid_search([2.0, 1.0, 0.5])}},
        tune_config=TuneConfig(
            metric="val", mode="max", max_concurrent_trials=1,
            scheduler=ASHAScheduler(max_t=4, grace_period=1,
                                    reduction_factor=2)),
        run_config=RunConfig(name="give_back", storage_path=str(tmp_path)),
    ).fit()
    assert grid.num_errors == 0
    assert sorted(r.metrics["training_iteration"] for r in grid) == [1, 1, 4]
    _wait_all_free()


# ---------------------------------------- the LoRA step swept over lrs

LRS = (3e-3, 1e-3)
STEPS = 3


def _jax_lora_steps(jc, batch, lr, n):
    """The JAX package's LoRA train step, as ``_run_jax_steps`` in
    ``tests/test_torch_train_step.py`` runs it, at ``optax.adamw(lr)``."""
    import jax
    import optax

    from ray_tpu.models import llama as jl
    from ray_tpu.parallel import train_step as jts
    from ray_tpu.parallel.mesh import MeshConfig, create_mesh
    from tests.test_torch_train_step import ALL_TARGETS, _np

    mesh = create_mesh(MeshConfig(data=-1), devices=jax.devices()[:1])
    tx = optax.adamw(lr)
    base = jl.init_llama(jc, jax.random.PRNGKey(0))
    lcfg = jl.LoraConfig(rank=4, targets=ALL_TARGETS)
    with jax.set_mesh(mesh):
        state, sh = jts.create_train_state(
            lambda k: jl.init_lora(jc, lcfg, k), tx, mesh,
            jl.lora_logical_axes(jc, lcfg), seed=1)
        step = jts.make_train_step(
            lambda lo, bb, fz: jl.llama_lora_loss(fz, lo, bb, jc, lcfg),
            tx, mesh, sh, batch_logical_axes=("batch", "seq"), frozen=base,
            frozen_logical_axes=jl.llama_logical_axes(jc), donate=False)
        init = _np(state.params)
        metrics = []
        for _ in range(n):
            state, m = step(state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"]),
                            int(m["step"])))
    return _np(base), init, metrics


def test_tuner_sweeps_lora_trainer_against_jax(port_cluster, tmp_path):
    """``Tuner(TorchTrainer(...))`` over ``train_loop_config.lr`` in {3e-3,
    1e-3}: each trial's gloo worker runs 3 ``adamw(lr)`` steps of the tiny
    Llama LoRA step (reference attention, fp32) and reports every step
    through the trainer's Tune hook; each trial's losses and grad norms
    equal the JAX package's train step at its lr within 1e-4 relative, as
    ``test_lora_trainer_matches_jax_train_step``."""
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer
    from tests.test_torch_train_step import ALL_TARGETS, _batch, _cfgs

    jc, _ = _cfgs(attn_impl="reference")
    b = _batch(8, 4, 16, jc.vocab_size)
    want, base, init = {}, None, None
    for lr in LRS:
        base, init, want[lr] = _jax_lora_steps(jc, b, lr, STEPS)

    def loop(config):
        import dataclasses

        import torch

        from ray_tpu_torch import train
        from ray_tpu_torch.models import llama as tl
        from ray_tpu_torch.parallel import optim as topt
        from ray_tpu_torch.parallel import train_step as tts

        torch.set_num_threads(1)
        cfg = dataclasses.replace(tl.LlamaConfig.tiny(), dtype=torch.float32,
                                  attn_impl="reference")
        lcfg = tl.LoraConfig(rank=4, targets=config["targets"])
        base = tl.params_from_jax(config["base"])
        batch = {k: torch.from_numpy(v).long()
                 for k, v in config["batch"].items()}
        tx = topt.adamw(config["lr"])
        state = tts.create_train_state(
            lambda g: tl.lora_from_jax(config["init"]), tx, device="cpu")
        step = tts.make_train_step(
            lambda lo, bb, fz: tl.llama_lora_loss(fz, lo, bb, cfg, lcfg),
            tx, frozen=base)
        history = []
        for _ in range(config["steps"]):
            state, m = step(state, batch)
            history.append((m["loss"].item(), m["grad_norm"].item(),
                            m["step"]))
            train.report({"loss": history[-1][0], "history": history})

    trainer = TorchTrainer(
        loop, train_loop_config={"targets": ALL_TARGETS, "base": base,
                                 "init": init, "batch": b, "steps": STEPS,
                                 "lr": 0.0},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False))
    grid = Tuner(
        trainer,
        param_space={"train_loop_config": {"lr": tune.grid_search(
            list(LRS))}},
        tune_config=TuneConfig(metric="loss", mode="min",
                               max_concurrent_trials=1),
        run_config=RunConfig(name="lora_sweep", storage_path=str(tmp_path)),
    ).fit()
    assert grid.num_errors == 0 and len(grid) == len(LRS)
    seen = set()
    for result in grid:
        lr = result.config["train_loop_config"]["lr"]
        seen.add(lr)
        got = [tuple(h) for h in result.metrics["history"]]
        assert [s for _, _, s in got] == [1, 2, 3], got
        for (gl, gn, _), (wl, wn, _) in zip(got, want[lr]):
            assert abs(gl - wl) <= 1e-4 * abs(wl), (lr, got, want[lr])
            assert abs(gn - wn) <= 1e-4 * abs(wn), (lr, got, want[lr])
    assert seen == set(LRS)
    # the two lrs part after the first step
    assert want[LRS[0]][1][0] != want[LRS[1]][1][0]
    best = grid.get_best_result()
    assert best.config["train_loop_config"]["lr"] == min(
        LRS, key=lambda lr: want[lr][-1][0])


# ------------------------------------------ trial actors sharing a card

def test_half_gpu_trials_share_the_device_id(port_cluster, tmp_path):
    """``resources_per_trial={"CPU": 1, "GPU": 0.5}``: two trial actors
    hold the one GPU id at once, each with ``CUDA_VISIBLE_DEVICES=0`` and
    no CUDA touched; a third waits until one has ended. Both overlap in
    time, so the share was real."""
    def objective(config):
        import os
        import sys
        import time

        from ray_tpu_torch import tune

        t0 = time.time()
        time.sleep(1.0)
        tune.report({"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                     "torch": "torch" in sys.modules, "t0": t0,
                     "t1": time.time(), "pid": os.getpid()})

    grid = Tuner(
        objective, param_space={"i": tune.grid_search([0, 1, 2])},
        tune_config=TuneConfig(max_concurrent_trials=3),
        run_config=RunConfig(name="half_gpu", storage_path=str(tmp_path)),
        resources_per_trial={"CPU": 1, "GPU": 0.5},
    ).fit()
    assert grid.num_errors == 0 and len(grid) == 3
    ms = sorted((r.metrics for r in grid), key=lambda m: m["t0"])
    assert all(m["visible"] == "0" and not m["torch"] for m in ms), ms
    assert len({m["pid"] for m in ms}) == 3
    # the first two ran side by side; the third began after one ended
    assert ms[1]["t0"] < ms[0]["t1"]
    assert ms[2]["t0"] >= min(ms[0]["t1"], ms[1]["t1"]) - 0.05
    _wait_all_free(30.0)  # the shares come back as the actors exit


def test_node_resources_share_a_device_by_halves():
    """The agent's ledger: shares below one unit take the id of a device
    that still has room, whole units only wholly free devices, and a
    release hands the device back whole once its shares are gone."""
    from ray_tpu_torch._private.resources import NodeResources, ResourceSet

    nr = NodeResources(ResourceSet({"CPU": 8, "GPU": 2}),
                       accelerator_ids={"GPU": [0, 1]})
    half = ResourceSet({"CPU": 1, "GPU": 0.5})
    assert nr.allocate(half, owner="a") == {"GPU": [0]}
    assert nr.allocate(half, owner="b") == {"GPU": [0]}
    assert nr.allocate(ResourceSet({"GPU": 0.3}), owner="c") == {"GPU": [1]}
    # 0.7 of a GPU is free, but on no single device for a whole one
    assert not nr.fits(ResourceSet({"GPU": 1}))
    assert nr.allocate(ResourceSet({"GPU": 0.8}), owner="d") is None
    nr.release(half, owner="a")
    nr.release(half, owner="b")
    assert nr.free_instances["GPU"] == [0]
    assert nr.allocate(ResourceSet({"GPU": 1}), owner="e") == {"GPU": [0]}
    nr.release(ResourceSet({"GPU": 0.3}), owner="c")
    assert nr.free_instances["GPU"] == [1]
    assert nr.available.get("GPU") == 1.0


# ------------------------------------------------------------ the boundary

def test_tune_imports_no_jax_and_no_ray_tpu():
    """``ray_tpu_torch.tune`` and ``ray_tpu_torch.air.integrations`` load
    neither jax nor the JAX package, nor torch."""
    code = (
        "import sys\n"
        "import ray_tpu_torch.tune, ray_tpu_torch.air.integrations\n"
        "import ray_tpu_torch.tune.search.tpe, "
        "ray_tpu_torch.tune.search.bayesopt\n"
        "import ray_tpu_torch.tune.schedulers.pb2\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ray_tpu', 'torch')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_rllib_trainables_import_no_jax_and_no_ray_tpu():
    """RLlib's ``Algorithm`` is a Tune ``Trainable``: the modules that
    subclass it (``algorithm``, PPO, multi-agent PPO, A2C, DD-PPO, IMPALA,
    APPO) load Tune without jax, the JAX package or gymnasium."""
    code = (
        "import importlib, sys\n"
        "from ray_tpu_torch.tune.trainable import Trainable\n"
        "mods = ['algorithm', 'ppo.ppo', 'ppo.multi_agent', 'a2c.a2c',\n"
        "        'ddppo.ddppo', 'impala.impala', 'appo.appo']\n"
        "for m in mods:\n"
        "    importlib.import_module('ray_tpu_torch.rllib.algorithms.' + m)\n"
        "from ray_tpu_torch.rllib import (A2C, APPO, DDPPO, IMPALA, PPO,\n"
        "                                 Algorithm, MultiAgentPPO)\n"
        "assert all(issubclass(c, Trainable) for c in (\n"
        "    A2C, APPO, DDPPO, IMPALA, PPO, Algorithm, MultiAgentPPO))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ray_tpu', 'gymnasium')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_trial_past_its_deadline_fails(port_cluster, tmp_path, monkeypatch):
    """An iteration that outlives ``tune_result_timeout_s`` fails its trial
    with a TimeoutError (retried as FailureConfig says), and the sweep ends
    instead of waiting on it."""
    monkeypatch.setenv("RAY_TPU_TORCH_TUNE_RESULT_TIMEOUT_S", "2")

    def objective(config):
        import time

        from ray_tpu_torch import tune

        tune.report({"i": 0})
        time.sleep(600)  # wedged

    grid = Tuner(
        objective, param_space={},
        run_config=RunConfig(name="wedged", storage_path=str(tmp_path)),
    ).fit()
    assert grid.num_errors == 1
    assert "TimeoutError" in str(grid.errors[0])
