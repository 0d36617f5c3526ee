"""ray_tpu_torch.data feeding the Train plane, against the JAX package, on
the CPU.

- ``TorchTrainer(datasets={"train": ds})`` on 2 gloo workers: each worker's
  ``get_dataset_shard("train")`` yields the rows that the same rank's shard
  yields under the JAX package's ``JaxTrainer`` (a ``DataParallelTrainer``)
  on the same dataset, bit for bit.
- The tiny dense step (adafactor(1e-3)) fed from ``range -> map_batches
  (tokenize) -> streaming_split(1) -> iter_torch_batches``: the tokens and
  the losses of ``bench._run_dense_datafed`` at the tiny config of
  ``tests/test_bench_datafed.py`` (batch 4, seq 64, 1 + 3 steps), in fp32 on
  both sides, from the JAX run's initial weights (carried across as
  numpy): every loss within 1e-5 relative.
- ``iter_torch_batches(sharding=)`` on a 2-rank data mesh
  (``tests/_torch_ranks.py``): each rank's rows are its shard of a DTensor
  whose full value is the global batch that ``jax.device_put`` puts on a
  ``NamedSharding``, and whose local shard is that device's shard.
- ``BatchPredictor`` with ``ParamsPredictor`` over a Dataset of prompts, in
  an actor: the tiny Llama's logits with LoRA adapters, against the JAX
  package's ``BatchPredictor`` with ``JaxPredictor`` on the same weights
  (``params_from_jax`` / ``lora_from_jax``), atol = rtol = 1e-4 (fp32).

Remote functions and train loops are defined inside the tests, so that they
travel by value and no worker imports this module (and with it jax). The
JAX package's cluster runs in a module fixture and is shut down straight
after; the trainers' result rounds have a deadline of 120 s."""

import dataclasses
import os

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import ray_tpu  # noqa: E402
import ray_tpu.data  # noqa: E402
import ray_tpu_torch  # noqa: E402
import ray_tpu_torch.data  # noqa: E402
from ray_tpu.models import llama as jl  # noqa: E402
from ray_tpu.parallel import sharding as jsh  # noqa: E402
from ray_tpu.parallel.mesh import MeshConfig, create_mesh  # noqa: E402
from ray_tpu_torch.models import llama as tl  # noqa: E402
from tests._torch_ranks import run_ranks  # noqa: E402
from tests.test_torch_runtime import port_session_leak_check  # noqa: E402
from tests.test_torch_train_step import _np  # noqa: E402

SEQ, BATCH, STEPS = 64, 4, 3  # tests/test_bench_datafed.py's tiny run
TARGETS = ("wq", "wv")


def _jcfg():
    return dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jnp.float32,
                               attn_impl="reference")


def _tcfg():
    return dataclasses.replace(tl.LlamaConfig.tiny(), dtype=torch.float32,
                               attn_impl="reference")


def _shard_loop():
    """A train loop (made here, so that it travels by value) in which each
    worker writes the ids of its dataset shard to a file named by its
    rank; ``config["pkg"]`` names the package whose session it runs in."""

    def loop(config):
        import importlib
        import os

        import numpy as np

        train = importlib.import_module(config["pkg"] + ".train")
        ids = [b["id"] for b in train.get_dataset_shard(
            "train").iter_batches(batch_size=5)]
        rank = train.get_context().get_world_rank()
        np.save(os.path.join(config["out"], f"rank{rank}.npy"),
                np.concatenate(ids))
        train.report({"rows": int(sum(len(i) for i in ids))})
    return loop


def _predict_jax(params, lora, prompts):
    from ray_tpu.train import BatchPredictor, Checkpoint
    from ray_tpu.train.predictor import JaxPredictor

    jc, lcfg = _jcfg(), jl.LoraConfig(rank=4, targets=TARGETS)

    def apply(p, x):
        return jl.llama_forward(p["base"], x, jc, lora=p["lora"],
                                lora_cfg=lcfg)

    ckpt = Checkpoint.from_dict({"params": {"base": params, "lora": lora}})
    ds = ray_tpu.data.from_numpy([prompts[:4], prompts[4:]],
                                 column="features")
    rows = BatchPredictor.from_checkpoint(
        ckpt, JaxPredictor, apply_fn=apply).predict(
        ds, batch_size=3, concurrency=1).take_all()
    return np.stack([r["predictions"] for r in rows])


@pytest.fixture(scope="module")
def port_cluster():
    key = "RAY_TPU_TORCH_TRAIN_RESULT_TIMEOUT_S"
    old = os.environ.get(key)
    os.environ[key] = "120"
    ray_tpu_torch.init(num_cpus=4)
    session_dir = ray_tpu_torch._global_node.session_dir
    yield session_dir
    ray_tpu_torch.shutdown()
    if old is None:
        os.environ.pop(key, None)
    else:
        os.environ[key] = old
    port_session_leak_check(session_dir)


@pytest.fixture(scope="module")
def inputs():
    jc = _jcfg()
    params = _np(jl.init_llama(jc, jax.random.PRNGKey(0)))
    lcfg = jl.LoraConfig(rank=4, targets=TARGETS)
    lora = _np(jl.init_lora(jc, lcfg, jax.random.PRNGKey(1)))
    # B nonzero, so that the adapters change the logits
    rng = np.random.RandomState(2)
    for ab in lora["layers"].values():
        ab["b"] = (0.02 * rng.standard_normal(ab["b"].shape)).astype(
            np.float32)
    prompts = rng.randint(0, jc.vocab_size, (7, 16)).astype(np.int32)
    return {"params": params, "lora": lora, "prompts": prompts}


@pytest.fixture(scope="module")
def jax_reference(port_cluster, inputs, tmp_path_factory):
    """Through the JAX package, in one session shut down straight after:
    the trainer's shards, ``bench._run_dense_datafed``'s initial params,
    batches and losses (recorded around its ``create_train_state`` and
    ``make_train_step``), and the batch predictor's outputs."""
    import bench
    from ray_tpu.air.config import RunConfig, ScalingConfig
    from ray_tpu.parallel import train_step as jts
    from ray_tpu.train.jax import JaxTrainer

    out_dir = str(tmp_path_factory.mktemp("jax_shards"))
    rec = {"losses": [], "batches": []}
    create, make = jts.create_train_state, jts.make_train_step

    def recording_create(*a, **kw):
        state, shardings = create(*a, **kw)
        rec["params"] = jax.tree.map(lambda t: np.array(t, copy=True),
                                     state.params)
        return state, shardings

    def recording_make(*a, **kw):
        step = make(*a, **kw)

        def recording_step(state, batch):
            rec["batches"].append({k: np.array(v) for k, v in batch.items()})
            state, m = step(state, batch)
            rec["losses"].append(float(m["loss"]))
            return state, m
        return recording_step

    ray_tpu.init(num_cpus=4)
    try:
        result = JaxTrainer(
            _shard_loop(), train_loop_config={"out": out_dir,
                                              "pkg": "ray_tpu"},
            scaling_config=ScalingConfig(num_workers=2,
                                         resources_per_worker={"CPU": 0.5}),
            run_config=RunConfig(name="shards", storage_path=out_dir),
            datasets={"train": ray_tpu.data.range(64, parallelism=4)}).fit()
        assert result.error is None, result.error
        shards = [np.load(os.path.join(out_dir, f"rank{r}.npy"))
                  for r in range(2)]
        jts.create_train_state, jts.make_train_step = (recording_create,
                                                       recording_make)
        try:
            _, _, n = bench._run_dense_datafed(
                dataclasses.replace(jl.LlamaConfig.tiny(),
                                    dtype=jnp.float32),
                batch=BATCH, seq=SEQ, steps=STEPS, platform="cpu")
        finally:
            jts.create_train_state, jts.make_train_step = create, make
        assert n == STEPS
        predictions = _predict_jax(inputs["params"], inputs["lora"],
                                   inputs["prompts"])
    finally:
        ray_tpu.shutdown()
    return {"shards": shards, "datafed": rec, "predictions": predictions}


def test_trainer_dataset_shards_match_jax(port_cluster, jax_reference,
                                          tmp_path):
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    result = TorchTrainer(
        _shard_loop(), train_loop_config={"out": str(tmp_path),
                                          "pkg": "ray_tpu_torch"},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        run_config=RunConfig(name="shards", storage_path=str(tmp_path)),
        datasets={"train": ray_tpu_torch.data.range(64, parallelism=4)},
    ).fit()
    assert result.error is None, result.error
    got = [np.load(tmp_path / f"rank{r}.npy") for r in range(2)]
    want = jax_reference["shards"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert sorted(np.concatenate(got).tolist()) == list(range(64))


def test_datafed_dense_step_matches_bench(port_cluster, jax_reference):
    """The port's data-fed loop, as ``bench._run_dense_datafed`` runs it:
    the same tokens in the same batches, and its losses."""
    import bench

    from ray_tpu_torch.parallel import optim as topt
    from ray_tpu_torch.parallel import train_step as tts

    want = jax_reference["datafed"]
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(), dtype=torch.float32)
    vocab = cfg.vocab_size

    def tokenize(ids, seq, vocab):
        """``bench._tokenize_rows``: row id -> seq + 1 tokens."""
        ids = np.asarray(ids, dtype=np.int64).reshape(-1, 1)
        pos = np.arange(seq + 1, dtype=np.int64)[None, :]
        tok = ((ids * 1000003 + pos * 7919 + 17) % vocab).astype(np.int32)
        return {"inputs": tok[:, :-1], "targets": tok[:, 1:]}

    ids = np.arange(7)
    for k, v in tokenize(ids, SEQ, vocab).items():
        np.testing.assert_array_equal(v, bench._tokenize_rows(
            ids, SEQ, vocab)[k])

    ds = ray_tpu_torch.data.range(BATCH * (STEPS + 2), parallelism=2
                                  ).map_batches(
        lambda tbl: tokenize(tbl["id"], SEQ, vocab), batch_size=BATCH)
    it = ds.streaming_split(1)[0]
    tx = topt.adafactor(1e-3)
    state = tts.create_train_state(
        lambda g: tl.params_from_jax(want["params"]), tx, device="cpu")
    step = tts.make_train_step(lambda p, b: tl.llama_loss(p, b, cfg), tx)
    losses, batches = [], []
    for batch in it.iter_torch_batches(
            batch_size=BATCH, device="cpu", prefetch_batches=2,
            dtypes={"inputs": torch.long, "targets": torch.long}):
        batches.append({k: v.numpy().copy() for k, v in batch.items()})
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        if len(losses) == 1 + STEPS:
            break
    assert len(want["batches"]) == len(batches) == 1 + STEPS
    for g, w in zip(batches, want["batches"]):
        for k in ("inputs", "targets"):
            np.testing.assert_array_equal(g[k], w[k])
    for g, w in zip(losses, want["losses"]):
        assert abs(g - w) <= 1e-5 * abs(w), (losses, want["losses"])


def test_iter_torch_batches_sharding_matches_device_put():
    rng = np.random.RandomState(5)
    cols = {"tokens": rng.randint(0, 100, (16, 6)).astype(np.int64),
            "x": rng.standard_normal(16).astype(np.float32)}
    bs = 2  # rows a rank a batch
    port = run_ranks("data_sharding", 2, {"columns": cols,
                                          "batch_size": bs})
    mesh = create_mesh(MeshConfig(data=-1), devices=jax.devices()[:2])
    spec = jsh.logical_to_spec(("batch", "seq"))
    assert len(port) == 16 // (2 * bs)
    for i, got in enumerate(port):
        rows = slice(i * 2 * bs, (i + 1) * 2 * bs)
        for k, v in cols.items():
            arr = jax.device_put(v[rows], NamedSharding(
                mesh, P(*spec[:v.ndim])))
            want = np.asarray(arr).astype(np.float64 if k == "x" else
                                          v.dtype)
            np.testing.assert_array_equal(got[k]["full"], want)
            shard0 = np.asarray(arr.addressable_shards[0].data)
            np.testing.assert_array_equal(got[k]["local"], shard0)
            assert got[k]["placements"] == ["Shard(dim=0)"]
        assert got["x"]["dtype"] == "torch.float64"


def test_batch_predictor_matches_jax(port_cluster, jax_reference, inputs,
                                     tmp_path):
    from ray_tpu_torch.train import (
        BatchPredictor, Checkpoint, ParamsPredictor, save_pytree)

    tc = _tcfg()
    lcfg = tl.LoraConfig(rank=4, targets=TARGETS)
    save_pytree({"params": {"base": tl.params_from_jax(inputs["params"]),
                            "lora": tl.lora_from_jax(inputs["lora"])}},
                str(tmp_path), "state")

    def apply(p, x):
        from ray_tpu_torch.models.llama import llama_forward

        return llama_forward(p["base"], x, tc, lora=p["lora"], lora_cfg=lcfg)

    prompts = inputs["prompts"]
    ds = ray_tpu_torch.data.from_numpy([prompts[:4], prompts[4:]],
                                       column="features")
    rows = BatchPredictor.from_checkpoint(
        Checkpoint(str(tmp_path)), ParamsPredictor, name="state",
        apply_fn=apply, device="cpu").predict(
        ds, batch_size=3, concurrency=1).take_all()
    got = np.stack([r["predictions"] for r in rows])
    np.testing.assert_array_equal(np.stack([r["features"] for r in rows]),
                                  prompts)
    want = jax_reference["predictions"]
    assert got.shape == want.shape == (7, 16, tc.vocab_size)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
