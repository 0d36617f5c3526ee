"""ray_tpu_torch's Train plane on the port's runtime, on the CPU:
``TorchTrainer`` with gloo workers runs the JAX package's trainer tests
(``tests/test_train.py``, ``tests/test_train_elastic.py``) to the same
expectations, and a one-worker fit of the tiny Llama LoRA step gives the
losses and grad norms of the JAX package's ``make_train_step``, a resumed
fit its next step.

One port cluster per module (``num_cpus=4`` and one GPU id with no card
behind it); the workers ask for no GPU (``use_gpu=False``) but in
``test_gpu_worker_in_its_bundle_sees_its_card``. Train loops are defined inside the tests, so that they
travel by value and no worker imports this module (and with it jax). The
result rounds have a deadline of 120 s, so that a wedged worker fails its
test instead of holding the run."""

import os
import subprocess
import sys

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import ray_tpu_torch  # noqa: E402
from ray_tpu_torch import train  # noqa: E402
from ray_tpu_torch.exceptions import TrainRendezvousError  # noqa: E402
from ray_tpu_torch.train import (  # noqa: E402
    Checkpoint, CheckpointConfig, FailureConfig, RunConfig, ScalingConfig,
    TorchConfig, TorchTrainer)
from tests.test_torch_runtime import port_session_leak_check  # noqa: E402
from tests.test_torch_train_step import (  # noqa: E402
    ALL_TARGETS, _batch, _cfgs, _run_jax_steps)
from tests.test_torch_runtime import (  # noqa: E402,F401
    other_workers_jax_sessions_end)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ScalingConfig(num_workers=2, use_gpu=False)


@pytest.fixture(scope="module")
def port_cluster():
    key = "RAY_TPU_TORCH_TRAIN_RESULT_TIMEOUT_S"
    old = os.environ.get(key)
    os.environ[key] = "120"
    # a GPU resource with one device id, so that a GPU worker's lease sets
    # CUDA_VISIBLE_DEVICES as on a card (nothing here runs CUDA)
    ray_tpu_torch.init(num_cpus=4, resources={"GPU": 1})
    session_dir = ray_tpu_torch._global_node.session_dir
    yield session_dir
    ray_tpu_torch.shutdown()
    if old is None:
        os.environ.pop(key, None)
    else:
        os.environ[key] = old
    port_session_leak_check(session_dir)


def test_allreduce_sgd_matches_numpy_replay(port_cluster, tmp_path):
    """2 gloo workers fit y = 2x + 1 on disjoint data, averaging their
    gradients with ``dist.all_reduce``; the result is a numpy replay of the
    same averaged-gradient SGD within 1e-5."""
    steps, lr = 30, 0.5

    def loop(config):
        import numpy as np
        import torch
        import torch.distributed as dist

        from ray_tpu_torch import train

        ctx = train.get_context()
        assert ctx.get_world_size() == 2
        rng = np.random.RandomState(ctx.get_world_rank())
        x = torch.from_numpy(rng.rand(64).astype(np.float32))
        y = 2 * x + 1
        w = torch.zeros((), requires_grad=True)
        b = torch.zeros((), requires_grad=True)
        for step in range(config["steps"]):
            loss = ((w * x + b - y) ** 2).mean()
            g = torch.stack(torch.autograd.grad(loss, (w, b)))
            dist.all_reduce(g)
            g /= 2
            with torch.no_grad():
                w -= config["lr"] * g[0]
                b -= config["lr"] * g[1]
            train.report({"step": step, "w": w.item(), "b": b.item(),
                          "backend": dist.get_backend()})

    result = TorchTrainer(
        loop, train_loop_config={"steps": steps, "lr": lr},
        scaling_config=CPU,
        run_config=RunConfig(name="sgd", storage_path=str(tmp_path)),
    ).fit()
    assert result.error is None, result.error
    data = []
    for rank in range(2):
        rng = np.random.RandomState(rank)
        x = rng.rand(64).astype(np.float32)
        data.append((x, 2 * x + 1))
    w = b = np.float32(0)
    for _ in range(steps):
        gw = np.mean([np.mean(2 * (w * x + b - y) * x) for x, y in data])
        gb = np.mean([np.mean(2 * (w * x + b - y)) for x, y in data])
        w, b = np.float32(w - lr * gw), np.float32(b - lr * gb)
    m = result.metrics
    assert m["step"] == steps - 1 and m["backend"] == "gloo"
    assert abs(m["w"] - w) <= 1e-5 * abs(w), (m, w, b)
    assert abs(m["b"] - b) <= 1e-5 * abs(b), (m, w, b)
    assert abs(m["w"] - 2.0) < 0.15 and abs(m["b"] - 1.0) < 0.15


def test_checkpoint_retention_and_resume(port_cluster, tmp_path):
    def loop(config):
        from ray_tpu_torch import train
        from ray_tpu_torch.train import Checkpoint

        ctx = train.get_context()
        start = 0
        ckpt = train.get_checkpoint()
        if ckpt is not None:
            start = ckpt.to_dict()["step"] + 1
        for step in range(start, config.get("until", 3)):
            c = Checkpoint.from_dict({"step": step}) \
                if ctx.get_world_rank() == 0 else None
            train.report({"step": step}, checkpoint=c)

    result = TorchTrainer(
        loop, scaling_config=CPU,
        run_config=RunConfig(
            name="ckpt", storage_path=str(tmp_path),
            checkpoint_config=CheckpointConfig(num_to_keep=2)),
    ).fit()
    assert result.error is None, result.error
    assert result.checkpoint is not None
    assert result.checkpoint.to_dict()["step"] == 2
    # top-K retention: only 2 checkpoint dirs remain
    kept = [d for d in os.listdir(result.path) if d.startswith("checkpoint_")]
    assert len(kept) == 2

    # resume from the returned checkpoint: the loop continues past step 2
    result2 = TorchTrainer(
        loop, train_loop_config={"until": 5}, scaling_config=CPU,
        run_config=RunConfig(name="ckpt2", storage_path=str(tmp_path)),
        resume_from_checkpoint=result.checkpoint,
    ).fit()
    assert result2.error is None, result2.error
    assert result2.metrics == {"step": 4}
    assert result2.checkpoint.to_dict()["step"] == 4


def test_worker_failure_restarts(port_cluster, tmp_path):
    marker = str(tmp_path / "failed_once")

    def loop(config):
        import os

        from ray_tpu_torch import train

        ctx = train.get_context()
        if ctx.get_world_rank() == 0 and not os.path.exists(config["marker"]):
            open(config["marker"], "w").close()
            raise RuntimeError("injected failure")
        train.report({"ok": 1})

    result = TorchTrainer(
        loop, train_loop_config={"marker": marker}, scaling_config=CPU,
        run_config=RunConfig(
            name="ft", storage_path=str(tmp_path),
            failure_config=FailureConfig(max_failures=2)),
    ).fit()
    assert result.error is None, result.error
    assert result.metrics == {"ok": 1}
    assert result.restarts == 1


def test_failures_exhausted(port_cluster, tmp_path):
    def loop(config):
        raise ValueError("always fails")

    result = TorchTrainer(
        loop, scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
        run_config=RunConfig(name="fail", storage_path=str(tmp_path)),
    ).fit()
    assert result.error is not None
    assert "always fails" in str(result.error)


def test_uneven_report_counts(port_cluster, tmp_path):
    """Ranks reporting different numbers of times must not wedge the
    result-polling barrier (DONE workers are not re-polled)."""

    def loop(config):
        from ray_tpu_torch import train

        ctx = train.get_context()
        n = 3 if ctx.get_world_rank() == 0 else 1
        for i in range(n):
            train.report({"i": i, "rank": ctx.get_world_rank()})

    result = TorchTrainer(
        loop, scaling_config=CPU,
        run_config=RunConfig(name="uneven", storage_path=str(tmp_path)),
    ).fit()
    assert result.error is None, result.error
    assert result.metrics["i"] == 2


def test_worker_kill_elastic_shrinks_world(port_cluster, tmp_path):
    """With elastic bounds, a worker's death (rank 1 calls ``os._exit(1)``
    once, at step 5) restarts the group at the surviving world size, from
    the newest in-store checkpoint."""
    marker = str(tmp_path / "killed_once")

    def loop(config):
        import os
        import pickle
        import time

        import numpy as np

        from ray_tpu_torch import train
        from ray_tpu_torch.train import InStoreCheckpoint, get_session

        ctx = train.get_context()
        session = get_session()

        def wait_acked(step):
            """Until the driver has re-owned this step's checkpoint shard
            (it acks with its next result request). A shard dies with its
            worker, and with the keepalive a finished loop drops, so a
            worker that ran ahead would leave no checkpoint to resume
            from."""
            deadline = time.monotonic() + 30
            while step in session._shard_refs and \
                    time.monotonic() < deadline:
                time.sleep(0.01)

        rng = np.random.RandomState(0)
        X = rng.randn(32, 4)
        y = X @ rng.randn(4)
        start, in_store_restore, w = 0, False, np.zeros(4)
        ckpt = train.get_checkpoint()
        if ckpt is not None:
            in_store_restore = isinstance(ckpt, InStoreCheckpoint)
            state = pickle.loads(bytes(ckpt.get_file("state.pkl")))
            start, w = state["step"] + 1, state["w"]
        for step in range(start, config["steps"]):
            w = w - 0.05 * 2.0 * X.T @ (X @ w - y) / len(y)
            wait_acked(step - 2)
            if ctx.get_world_rank() == 1 and step >= 5 and \
                    not os.path.exists(config["marker"]):
                wait_acked(step - 1)
                open(config["marker"], "w").close()
                os._exit(1)
            train.report(
                {"step": step, "resumed_from": start,
                 "in_store_restore": in_store_restore,
                 "world_size": ctx.get_world_size(),
                 "loss": float(np.mean((X @ w - y) ** 2))},
                checkpoint=InStoreCheckpoint.from_state(
                    {"state.pkl": pickle.dumps({"step": step, "w": w})},
                    step=step))

    result = TorchTrainer(
        loop, train_loop_config={"steps": 20, "marker": marker},
        scaling_config=ScalingConfig(num_workers=2, min_workers=1,
                                     use_gpu=False),
        run_config=RunConfig(
            name="elastic", storage_path=str(tmp_path),
            failure_config=FailureConfig(max_failures=3)),
    ).fit()
    assert os.path.exists(marker), "the kill never fired"
    assert result.error is None, result.error
    assert result.restarts >= 1
    m = result.metrics
    assert m["step"] == 19
    assert m["world_size"] == 1  # shrank from 2 to the survivor
    assert m["resumed_from"] >= 1
    assert m["in_store_restore"] is True


def test_last_iteration_in_store_checkpoint_is_kept(port_cluster, tmp_path):
    """Each of 2 workers reports an in-store checkpoint at every step, the
    last one included, and runs on without waiting for the driver's acks.
    The loop's end holds its unacked shards until the driver has re-owned
    them, so the ``Result`` carries the last step's checkpoint, with both
    ranks' files laid out as a disk checkpoint's (rank 1's under
    ``rank_1/``). (The JAX package drops the shards at the loop's end,
    before the driver reads them, and its ``Result`` carries no in-store
    checkpoint.)"""

    def loop(config):
        import pickle

        from ray_tpu_torch import train
        from ray_tpu_torch.train import InStoreCheckpoint

        ctx = train.get_context()
        for step in range(config["steps"]):
            train.report(
                {"step": step},
                checkpoint=InStoreCheckpoint.from_state(
                    {"state.pkl": pickle.dumps(
                        {"step": step, "rank": ctx.get_world_rank()})},
                    step=step))

    result = TorchTrainer(
        loop, train_loop_config={"steps": 4}, scaling_config=CPU,
        run_config=RunConfig(name="last_in_store",
                             storage_path=str(tmp_path)),
    ).fit()
    assert result.error is None, result.error
    assert result.metrics == {"step": 3}
    ckpt = result.checkpoint
    assert isinstance(ckpt, train.InStoreCheckpoint), ckpt
    assert ckpt.step == 3
    import pickle

    assert sorted(ckpt.files()) == ["rank_1/state.pkl", "state.pkl"]
    assert pickle.loads(bytes(ckpt.get_file("state.pkl"))) == {
        "step": 3, "rank": 0}
    assert pickle.loads(bytes(ckpt.get_file("rank_1/state.pkl"))) == {
        "step": 3, "rank": 1}
    with open(os.path.join(ckpt.path, "rank_1", "state.pkl"), "rb") as f:
        assert pickle.load(f) == {"step": 3, "rank": 1}


def test_nccl_without_a_card_fails_fit(port_cluster, tmp_path,
                                      monkeypatch):
    """No fallback: a NCCL group that cannot form (here: no CUDA) fails the
    rendezvous on every attempt (one here), and ``fit`` returns the error;
    the loop never runs on gloo."""
    monkeypatch.setenv("RAY_TPU_TORCH_TRAIN_RENDEZVOUS_MAX_RETRIES", "1")

    def loop(config):
        from ray_tpu_torch import train

        train.report({"ran": True})

    result = TorchTrainer(
        loop, torch_config=TorchConfig(backend="nccl"),
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
        run_config=RunConfig(name="nccl", storage_path=str(tmp_path)),
    ).fit()
    assert result.error is not None and result.metrics is None
    assert isinstance(result.error.__cause__, TrainRendezvousError)


def test_gpu_worker_in_its_bundle_sees_its_card(port_cluster, tmp_path):
    """``use_gpu=True`` (the default) reserves a GPU bundle; the worker that
    takes it gets the bundle's device as ``CUDA_VISIBLE_DEVICES``, as a GPU
    lease outside a placement group does, and the device id comes back when
    the group is removed. (Here over gloo: the GPU id has no card.)"""

    def loop(config):
        import os

        from ray_tpu_torch import train

        train.report({"visible": os.environ.get("CUDA_VISIBLE_DEVICES")})

    result = TorchTrainer(
        loop, torch_config=TorchConfig(backend="gloo"),
        scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(name="gpu", storage_path=str(tmp_path)),
    ).fit()
    assert result.error is None, result.error
    assert result.metrics == {"visible": "0"}

    @ray_tpu_torch.remote(num_gpus=1)
    def visible():
        import os

        return os.environ.get("CUDA_VISIBLE_DEVICES")

    assert ray_tpu_torch.get(visible.remote(), timeout=60) == "0"


def test_lora_trainer_matches_jax_train_step(port_cluster, tmp_path):
    """One gloo worker runs 3 ``adamw(3e-3)`` steps of the tiny Llama LoRA
    step and checkpoints its state (params, AdamW moments, step) through
    ``save_pytree``; a second fit resumes from it and runs a 4th. Losses
    and grad norms equal the JAX package's ``make_train_step`` over 4
    steps within 1e-4 relative, as ``test_train_step_matches_jax``."""
    # reference attention on both sides: the kernels' twins have their
    # own tests, and Pallas in interpret mode would double this test's time
    jc, _ = _cfgs(attn_impl="reference")
    b = _batch(8, 4, 16, jc.vocab_size)
    base, init, want, _ = _run_jax_steps("lora", jc, b, 4)

    def loop(config):
        import dataclasses
        import shutil
        import tempfile

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
        tx = topt.adamw(3e-3)
        ckpt = train.get_checkpoint()
        if ckpt is None:
            state = tts.create_train_state(
                lambda g: tl.lora_from_jax(config["init"]), tx,
                device="cpu")
        else:
            with ckpt.as_directory() as d:
                state = tts.load_train_state(
                    train.load_pytree(d, "state"), tx, device="cpu")
        step = tts.make_train_step(
            lambda lo, bb, fz: tl.llama_lora_loss(fz, lo, bb, cfg, lcfg),
            tx, frozen=base)
        history = []
        for i in range(config["steps"]):
            state, m = step(state, batch)
            history.append((m["loss"].item(), m["grad_norm"].item(),
                            m["step"]))
            d = None
            if i == config["steps"] - 1:
                d = tempfile.mkdtemp()
                train.save_pytree(tts.train_state_tree(state), d, "state")
            train.report({"history": history},
                         checkpoint=train.Checkpoint(d) if d else None)
            if d:
                shutil.rmtree(d)

    cfg = {"targets": ALL_TARGETS, "base": base, "init": init, "batch": b}
    one = ScalingConfig(num_workers=1, use_gpu=False)

    result = TorchTrainer(
        loop, train_loop_config=dict(cfg, steps=3), scaling_config=one,
        run_config=RunConfig(name="lora", storage_path=str(tmp_path)),
    ).fit()
    assert result.error is None, result.error
    resumed = TorchTrainer(
        loop, train_loop_config=dict(cfg, steps=1), scaling_config=one,
        run_config=RunConfig(name="lora2", storage_path=str(tmp_path)),
        resume_from_checkpoint=result.checkpoint,
    ).fit()
    assert resumed.error is None, resumed.error
    got = [tuple(h) for h in
           result.metrics["history"] + resumed.metrics["history"]]
    assert [s for _, _, s in got] == [s for _, _, s in want] == [1, 2, 3, 4]
    for (gl, gn, _), (wl, wn, _) in zip(got, want):
        assert abs(gl - wl) <= 1e-4 * abs(wl), (got, want)
        assert abs(gn - wn) <= 1e-4 * abs(wn), (got, want)


def test_train_imports_no_jax_and_no_ray_tpu():
    """The Train plane's modules load neither jax nor the JAX package, nor
    torch until a loop or a checkpoint asks for it."""
    code = (
        "import sys\n"
        "import ray_tpu_torch.train, ray_tpu_torch.train.torch\n"
        "import ray_tpu_torch.air\n"
        "import ray_tpu_torch._private.storage\n"
        "import ray_tpu_torch.util.placement_group\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ray_tpu', 'torch')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
