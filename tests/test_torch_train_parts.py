"""The parts of ray_tpu_torch's Train plane that need no runtime, against
the JAX package's, on the CPU: ``save_pytree`` / ``load_pytree``, the
checkpoint manager's retention, ``ScalingConfig``'s bundles, the train
state's round trip through a checkpoint, and ``ParamsPredictor`` against
``JaxPredictor`` on a tiny Llama.

Inputs are drawn with numpy from a seed and given to both packages."""

import dataclasses
import os

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from ray_tpu import train as jtrain  # noqa: E402
from ray_tpu.air.config import CheckpointConfig as JCheckpointConfig  # noqa: E402
from ray_tpu.air.config import ScalingConfig as JScalingConfig  # noqa: E402
from ray_tpu.models import llama as jl  # noqa: E402
from ray_tpu.train._internal.checkpoint_manager import (  # noqa: E402
    CheckpointManager as JCheckpointManager)
from ray_tpu_torch import train as ttrain  # noqa: E402
from ray_tpu_torch._private.tree import tree_flatten, tree_leaves  # noqa: E402
from ray_tpu_torch.air.config import CheckpointConfig, ScalingConfig  # noqa: E402
from ray_tpu_torch.models import llama as tl  # noqa: E402
from ray_tpu_torch.parallel import optim as topt  # noqa: E402
from ray_tpu_torch.parallel import train_step as tts  # noqa: E402
from ray_tpu_torch.train._internal.checkpoint_manager import (  # noqa: E402
    CheckpointManager)
from tests.test_torch_runtime import (  # noqa: E402,F401
    other_workers_jax_sessions_end)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier runs files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy_tree(seed):
    """fp32, bf16 and int32 leaves in dicts and lists, 0-dim ones too."""
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((3, 5)).astype(np.float32),
        "emb": rng.standard_normal((4, 8)).astype(ml_dtypes.bfloat16),
        "layers": [
            {"a": rng.standard_normal((2, 6)).astype(ml_dtypes.bfloat16),
             "n": rng.integers(-9, 9, (7,)).astype(np.int32)},
            {"a": rng.standard_normal((2, 6)).astype(ml_dtypes.bfloat16),
             "n": np.int32(rng.integers(0, 100))},
        ],
        "scale": np.float32(rng.standard_normal()),
    }


def _bits(arr):
    """An array's raw bytes as integers of its width: bf16 (and the JAX
    package's reloaded |V2) compare bit for bit."""
    arr = np.ascontiguousarray(arr)
    return arr.view({2: np.uint16, 4: np.uint32}[arr.dtype.itemsize])


def test_save_load_pytree_matches_jax(tmp_path):
    tree = _numpy_tree(0)
    jtrain.save_pytree(tree, str(tmp_path / "jax"))
    want = jax.tree.leaves(jtrain.load_pytree(str(tmp_path / "jax")))
    ttrain.save_pytree(tree, str(tmp_path / "port"))
    back = ttrain.load_pytree(str(tmp_path / "port"))
    got = tree_leaves(back)
    orig = jax.tree.leaves(tree)
    assert len(got) == len(want) == len(orig) == 7
    # the same structure, dict keys and list order kept
    assert sorted(back) == sorted(tree) and len(back["layers"]) == 2
    assert back["layers"][1]["n"].shape == ()
    for g, w, o in zip(got, want, orig):
        o = np.asarray(o)
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        assert tuple(g.shape) == o.shape == np.asarray(w).shape
        if o.dtype.name == "bfloat16":
            # kept as bf16, bit for bit; the JAX package's load gives the
            # same bits as |V2, its dtype lost (ROADMAP Queue 3)
            assert g.dtype == torch.bfloat16
            g_bits = g.view(torch.int16).numpy().view(np.uint16)
            np.testing.assert_array_equal(g_bits, _bits(o))
            np.testing.assert_array_equal(g_bits, _bits(np.asarray(w)))
        else:
            assert str(g.dtype) == f"torch.{o.dtype.name}" == \
                f"torch.{np.asarray(w).dtype.name}"
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            np.testing.assert_array_equal(g.numpy(), o)
    # the leaves are stored in the JAX package's order under its names
    with np.load(tmp_path / "jax" / "params.npz") as jz, \
            np.load(tmp_path / "port" / "params.npz") as tz:
        assert sorted(jz.files) == sorted(tz.files)
        for name in jz.files:
            np.testing.assert_array_equal(_bits(tz[name]), _bits(jz[name]))


def test_save_load_pytree_of_tensors_round_trip(tmp_path):
    """A tensor tree (bf16 included) with tuples and None comes back as it
    went, on the device asked for."""
    g = torch.Generator().manual_seed(1)
    tree = {"p": (torch.randn(3, 4, generator=g).to(torch.bfloat16),
                  torch.arange(5, dtype=torch.int64)),
            "q": [None, torch.randn(2, generator=g)],
            "ok": torch.tensor([True, False])}
    ttrain.save_pytree(tree, str(tmp_path), name="t")
    back = ttrain.load_pytree(str(tmp_path), name="t", device="cpu")
    assert isinstance(back["p"], tuple) and back["q"][0] is None
    (want, _), (got, _) = tree_flatten(tree), tree_flatten(back)
    assert len(got) == len(want) == 4
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("num_to_keep,attr,order", [
    (2, None, "max"), (3, "acc", "max"), (2, "loss", "min"), (None, None,
                                                            "max")])
def test_checkpoint_manager_retention_matches_jax(tmp_path, num_to_keep,
                                                  attr, order):
    """The same report sequence through both managers keeps the same
    checkpoints, on disk and as latest and best."""
    rng = np.random.default_rng(3)
    reports = [{"acc": float(rng.uniform()), "loss": float(rng.uniform())}
               for _ in range(7)]
    del reports[4]["acc"]  # a report without the score ranks worst
    kept = {}
    for name, mgr_cls, cfg_cls in (
            ("jax", JCheckpointManager, JCheckpointConfig),
            ("port", CheckpointManager, CheckpointConfig)):
        mgr = mgr_cls(cfg_cls(num_to_keep=num_to_keep,
                              checkpoint_score_attribute=attr,
                              checkpoint_score_order=order))
        root = tmp_path / name
        for i, m in enumerate(reports):
            d = root / f"checkpoint_{i:06d}"
            d.mkdir(parents=True)
            ckpt = (jtrain if name == "jax" else ttrain).Checkpoint(str(d))
            mgr.register_checkpoint(ckpt, m)
        kept[name] = (sorted(os.listdir(root)),
                      os.path.basename(mgr.latest_checkpoint.path),
                      os.path.basename(mgr.best_checkpoint.path),
                      [(os.path.basename(c.path), m)
                       for c, m in mgr.best_checkpoints()])
    assert kept["port"] == kept["jax"]
    assert len(kept["port"][0]) == (num_to_keep or len(reports))


def test_scaling_config_bundles():
    """use_gpu (the default) asks each worker for a GPU; use_gpu=False is
    the JAX package's CPU bundle; the elastic bounds check as there."""
    assert ScalingConfig().use_gpu
    gpu = ScalingConfig(num_workers=2)
    assert gpu.as_placement_group_bundles() == [{"GPU": 1.0, "CPU": 1.0}] * 2
    cpu = ScalingConfig(num_workers=3, use_gpu=False)
    assert cpu.as_placement_group_bundles() == JScalingConfig(
        num_workers=3).as_placement_group_bundles() == [{"CPU": 1.0}] * 3
    own = ScalingConfig(num_workers=2, resources_per_worker={"GPU": 2,
                                                             "CPU": 4})
    assert own.as_placement_group_bundles() == JScalingConfig(
        num_workers=2, resources_per_worker={"GPU": 2, "CPU": 4}
    ).as_placement_group_bundles()
    for kw in ({"num_workers": 2, "min_workers": 3},
               {"num_workers": 2, "max_workers": 1}):
        with pytest.raises(ValueError):
            JScalingConfig(**kw)
        with pytest.raises(ValueError):
            ScalingConfig(**kw)
    assert ScalingConfig(num_workers=2, min_workers=1).elastic == \
        JScalingConfig(num_workers=2, min_workers=1).elastic is True


def test_train_state_round_trip_resumes_exactly(tmp_path):
    """Two AdamW steps, the state through save_pytree and load_pytree, a
    third step: the same loss, grad norm and params, bit for bit, as a
    third step of the state that never left the process."""
    cfg = dataclasses.replace(tl.LlamaConfig.tiny(), dtype=torch.float32)
    lcfg = tl.LoraConfig(rank=4)
    g = torch.Generator().manual_seed(0)
    base = tl.init_llama(cfg, g, torch.device("cpu"))
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 17)))
    batch = {"inputs": tok[:, :-1], "targets": tok[:, 1:]}
    tx = topt.adamw(3e-3)
    state = tts.create_train_state(
        lambda gen: tl.init_lora(cfg, lcfg, gen, gen.device), tx,
        device="cpu", seed=1)
    step = tts.make_train_step(
        lambda lo, b, fz: tl.llama_lora_loss(fz, lo, b, cfg, lcfg), tx,
        frozen=base)
    for _ in range(2):
        state, _ = step(state, batch)
    ttrain.save_pytree(tts.train_state_tree(state), str(tmp_path), "state")
    resumed = tts.load_train_state(
        ttrain.load_pytree(str(tmp_path), "state"), tx, device="cpu")
    assert resumed.step == 2
    state, want = step(state, batch)
    resumed, got = step(resumed, batch)
    assert got["step"] == want["step"] == 3
    assert got["loss"].item() == want["loss"].item()
    assert got["grad_norm"].item() == want["grad_norm"].item()
    for a, b in zip(tree_leaves(resumed.params), tree_leaves(state.params)):
        assert torch.equal(a, b)


def test_params_predictor_matches_jax_predictor(tmp_path):
    """A tiny fp32 Llama's logits through JaxPredictor and through the
    port's ParamsPredictor from a save_pytree checkpoint of the same
    weights, within 1e-4 (test_torch_train_step.py's tolerance for the
    loss path on the same tiny model)."""
    jc = dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jnp.float32)
    tc = dataclasses.replace(tl.LlamaConfig.tiny(), dtype=torch.float32)
    params = jax.tree.map(np.asarray,
                          jl.init_llama(jc, jax.random.PRNGKey(4)))
    tokens = np.random.RandomState(5).randint(
        0, jc.vocab_size, (3, 16)).astype(np.int32)
    jpred = jtrain.JaxPredictor(
        jax.tree.map(jnp.asarray, params),
        lambda p, x: jl.llama_forward(p, x, jc))
    want = jpred.predict({"features": tokens})["predictions"]
    ttrain.save_pytree({"params": tl.params_from_jax(params)},
                       str(tmp_path), name="state")
    tpred = ttrain.ParamsPredictor.from_checkpoint(
        ttrain.Checkpoint(str(tmp_path)), name="state", device="cpu",
        apply_fn=lambda p, x: tl.llama_forward(p, x.long(), tc))
    out = tpred.predict({"features": tokens, "id": np.arange(3)})
    got = out["predictions"]
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    np.testing.assert_array_equal(out["id"], np.arange(3))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=0)


def test_params_predictor_needs_cuda_by_default(monkeypatch):
    """``device=None`` is the card: without one the predictor raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.ParamsPredictor({"w": torch.ones(2)}, lambda p, x: x)
