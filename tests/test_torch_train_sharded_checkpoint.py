"""The port's sharded checkpoints (``save_pytree_orbax`` /
``load_pytree_orbax`` over ``torch.distributed.checkpoint``) against the
JAX package's orbax pair, on the CPU.

A tree of an fp32 and a bf16 matrix, a 0-dim fp32 count and a Python step,
drawn from a numpy seed, is saved by 4 spawned gloo ranks
(``tests/_torch_ranks.py``) on (fsdp=2, tensor=2), each rank writing its
own shards with ``full_tensor`` refused; it is loaded back on (fsdp=4) in
4 ranks and whole in this process. Both loads must equal the JAX package's
``save_pytree_orbax`` → ``load_pytree_orbax`` round trip of the same tree
bit for bit. A tiny Llama LoRA state on (fsdp=2, tensor=2) is saved after
2 AdamW steps (``sharded_train_state_tree``) and resumed into a fresh state
(``train_state_from_tree``): its steps 3-4 must equal the uninterrupted
run's bit for bit (tolerance 0: the same ranks run the same ops on the same
values). Every view of a DTensor in the saves and loads is held to torch
2.11's rule (``ShardedMergeRecorder``)."""

import os

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from ray_tpu.train import _checkpoint as jck  # noqa: E402
from ray_tpu_torch.models import llama as tl  # noqa: E402
from ray_tpu_torch.train import (  # noqa: E402
    load_pytree_orbax, save_pytree_orbax)
from tests._torch_ranks import run_ranks  # noqa: E402
from tests.test_torch_train_step import ALL_TARGETS, _batch  # noqa: E402
from tests.test_torch_runtime import (  # noqa: E402,F401
    other_workers_jax_sessions_end)


def _tree_np(seed=0):
    rng = np.random.RandomState(seed)
    w16 = rng.randn(16, 4).astype(np.float32).astype(ml_dtypes.bfloat16)
    return {"w32": rng.randn(8, 12).astype(np.float32),
            "w16_bits": w16.view(np.uint16),
            "count": np.asarray(rng.randn(), np.float32), "step": 7}


def _jax_round_trip(tree, tmp):
    jt = {"w32": jnp.asarray(tree["w32"]),
          "w16": jnp.asarray(tree["w16_bits"].view(ml_dtypes.bfloat16)),
          "count": jnp.asarray(tree["count"]), "step": tree["step"]}
    jck.save_pytree_orbax(jt, tmp)
    out = jck.load_pytree_orbax(tmp, jt)
    return {"w32": np.asarray(out["w32"]),
            "w16_bits": np.asarray(out["w16"]).view(np.uint16),
            "count": np.asarray(out["count"]), "step": out["step"]}


def _assert_bit_equal(got, want):
    assert got["step"] == want["step"]
    for k in ("w32", "w16_bits", "count"):
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    base = tmp_path_factory.mktemp("sharded_ckpt")
    tree = _tree_np()
    cfg = tl.LlamaConfig.tiny()
    inputs = dict(tree, dir=str(base / "tree"), lora_dir=str(base / "lora"),
                  targets=ALL_TARGETS, batch=_batch(3, 4, 16, cfg.vocab_size))
    out = run_ranks("ckpt_save", 4, inputs)
    want = _jax_round_trip(tree, str(base / "jax"))
    return dict(inputs=inputs, out=out, want=want, tree=tree)


def test_ranks_write_their_own_shards(saved):
    """The checkpoint's index: each matrix in 4 chunks of a quarter each
    at 4 offsets, one file a rank; no chunk holds a whole matrix, as a
    gathered save would write it."""
    import torch.distributed.checkpoint as dcp

    d = os.path.join(saved["inputs"]["dir"], "dcp")
    meta = dcp.FileSystemReader(d).read_metadata()
    leaves = {"w32": (8, 12), "w16": (16, 4)}
    assert sorted(meta.state_dict_metadata) == ["count", "step", "w16",
                                                "w32"]
    for name in ("w32", "w16"):
        chunks = meta.state_dict_metadata[name].chunks
        assert tuple(meta.state_dict_metadata[name].size) == leaves[name]
        assert len(chunks) == 4, (name, chunks)
        for c in chunks:
            assert int(np.prod(c.sizes)) * 4 == int(np.prod(leaves[name]))
        assert len({tuple(c.offsets) for c in chunks}) == 4, chunks
    assert len([f for f in os.listdir(d) if f.endswith(".distcp")]) == 4


def test_load_on_fsdp4_equals_jax_orbax_round_trip(saved):
    out = run_ranks("ckpt_load", 4, {"dir": saved["inputs"]["dir"],
                                     "w32": saved["tree"]["w32"],
                                     "w16_bits": saved["tree"]["w16_bits"]})
    _assert_bit_equal(out, saved["want"])
    assert out["mesh"] == ["fsdp"]
    assert out["placements"] == ["(Shard(dim=0),)"] * 2
    assert out["breaches"] == []


def test_load_in_one_process_equals_jax_orbax_round_trip(saved):
    like = {"w32": torch.zeros(8, 12), "w16": torch.zeros(
        16, 4, dtype=torch.bfloat16), "count": torch.zeros(()), "step": 0}
    before = {k: v.clone() if isinstance(v, torch.Tensor) else v
              for k, v in like.items()}
    out = load_pytree_orbax(saved["inputs"]["dir"], like)
    got = {"w32": out["w32"].numpy(),
           "w16_bits": out["w16"].view(torch.int16).numpy().view(np.uint16),
           "count": out["count"].numpy(), "step": out["step"]}
    _assert_bit_equal(got, saved["want"])
    for k, v in before.items():  # like is left as it was
        assert (torch.equal(like[k], v) if isinstance(v, torch.Tensor)
                else like[k] == v)


def test_one_process_round_trip(tmp_path):
    """Without a process group the whole tree is written by this process,
    and comes back as it went."""
    tree = _tree_np(1)
    t = {"w32": torch.from_numpy(tree["w32"]),
         "w16": torch.from_numpy(tree["w16_bits"].view(np.int16)).view(
             torch.bfloat16),
         "count": torch.from_numpy(tree["count"]), "step": tree["step"]}
    save_pytree_orbax(t, str(tmp_path))
    out = load_pytree_orbax(str(tmp_path), {k: torch.zeros_like(v)
                                            if isinstance(v, torch.Tensor)
                                            else 0 for k, v in t.items()})
    for k in ("w32", "w16", "count"):
        assert torch.equal(out[k], t[k]) and out[k].dtype == t[k].dtype
    assert out["step"] == tree["step"]


def test_load_matches_leaves_by_path(tmp_path):
    """A leaf is stored under its path: a ``like`` whose dict holds the
    leaves under other keys gets each value back in its own place, and a
    ``like`` with a renamed leaf raises (DCP's missing-key check) where a
    match by flatten index would fill it from another leaf of that
    shape."""
    from torch.distributed.checkpoint.api import CheckpointException

    a = torch.arange(6.0).reshape(2, 3)
    save_pytree_orbax({"a": a, "b": [-a]}, str(tmp_path))
    out = load_pytree_orbax(str(tmp_path), {"b": [torch.zeros(2, 3)],
                                            "a": torch.zeros(2, 3)})
    assert torch.equal(out["a"], a) and torch.equal(out["b"][0], -a)
    with pytest.raises(CheckpointException,
                       match=r"Missing key in checkpoint state_dict: c\."):
        load_pytree_orbax(str(tmp_path), {"c": torch.zeros(2, 3),
                                          "b": [torch.zeros(2, 3)]})


def test_lora_state_resumes_bit_equal(saved):
    out = saved["out"]
    assert out["start"] == 2
    assert [m[2] for m in out["continued"]] == [3, 4]
    assert out["resumed"] == out["continued"]
    assert out["placed"] and all(out["placed"])


def test_saves_and_loads_keep_torch_2_11_view_rule(saved):
    assert saved["out"]["breaches"] == []
