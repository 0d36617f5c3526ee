"""The port's multichip entry (``ray_tpu_torch.dryrun``) against the JAX
package's (``__graft_entry__``), on the CPU.

- ``entry()``: the tiny Llama's forward with JAX's ``entry()`` params
  carried across equals JAX's, at ``tests/test_torch_llama.py``'s bf16
  limits (max 0.1, relative norm 2e-2).
- ``dryrun_multichip(4)`` over 4 gloo ranks: every section's start and ok
  lines in the JAX gate's order (tiny mesh on (fsdp=2, tensor=2), GPipe on
  (stage=4), DD-PPO on (data=4), MoE EP on (expert=4), the two process
  gates), each with its assert (a positive or finite loss), and the final
  "all 6 sections ok" line. The 8-rank run (its 7B-widths section) is not
  run here: see ``CHANGES.md``.
- ``dryrun_two_slice()`` (as the dry run calls it): every rank's per-slice
  partials, global total and hierarchical-gradient step equal JAX's,
  computed here as the JAX worker computes them (``shard_map`` over a
  (dcn=2, ici=2) mesh of 4 virtual devices; the sums are of small
  integers, exact in fp32; the step at atol 1e-6).
- ``dryrun_two_process()`` (the same): the 4 ranks of 2 hosts report one
  loss, positive and the same on every rank.

The dry run runs once for the module (16 rank processes in all), its
output read from file descriptor 1, which its rank processes share.
"""

import contextlib
import os
import re
import sys
import tempfile
from functools import partial

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import __graft_entry__ as jentry  # noqa: E402
from ray_tpu_torch import dryrun  # noqa: E402
from ray_tpu_torch.models import llama as tl  # noqa: E402

SECTIONS = ["tiny-4d-mesh", "pipeline-gpipe", "ddppo-data-mesh",
            "moe-expert-mesh", "two-process-mesh", "two-slice-dcn"]


def test_entry_matches_jax():
    jfn, (jparams, jtokens) = jentry.entry()
    want = np.asarray(jax.jit(jfn)(jparams, jtokens), np.float32)
    fn, (params, tokens) = dryrun.entry(device="cpu")
    assert tokens.shape == jtokens.shape and not tokens.any()
    params = tl.params_from_jax(jax.tree.map(np.asarray, jparams))
    with torch.no_grad():
        got = fn(params, tokens).numpy()
    assert got.shape == want.shape == (2, 128, 256)
    assert np.abs(got - want).max() < 0.1
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 2e-2


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default does not raise")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.entry()


@pytest.fixture(scope="module")
def multichip():
    """``dryrun_multichip(4)`` on gloo ranks: (its result, all it and its
    rank processes printed)."""
    with tempfile.TemporaryFile(mode="w+") as f:
        sys.stdout.flush()
        saved = os.dup(1)
        os.dup2(f.fileno(), 1)
        try:
            with contextlib.redirect_stdout(f):
                result = dryrun.dryrun_multichip(4, device="cpu")
        finally:
            f.flush()
            os.dup2(saved, 1)
            os.close(saved)
        f.seek(0)
        return result, f.read()


def test_dryrun_multichip_4_ranks(multichip):
    result, out = multichip
    assert [n for n, _ in result["sections"]] == SECTIONS
    starts = [m.group(1) for m in re.finditer(
        r"^\[dryrun\] (\S+): start$", out, re.M)]
    oks = [m.group(1) for m in re.finditer(
        r"^\[dryrun\] (\S+): ok in [\d.]+s$", out, re.M)]
    assert starts == oks == SECTIONS
    assert "FAILED" not in out
    lines = [ln for ln in out.splitlines() if ln.endswith(" ok")]
    want = [r"dryrun_multichip\(4\): mesh=\{'data': 1, 'stage': 1, 'fsdp': "
            r"2, 'seq': 1, 'tensor': 2, 'expert': 1\} loss=",
            r"dryrun_multichip\(4\): PP mesh=\{'data': 1, 'stage': 4, ",
            r"dryrun_multichip\(4\): DD-PPO data mesh=\{'data': 4\} loss=",
            r"dryrun_multichip\(4\): MoE EP mesh=\{'data': 1, .*'expert': "
            r"4\} loss=",
            r"dryrun_two_process: 2 procs x 2 devices -> one 4-device "
            r"global mesh, full train step ok",
            r"dryrun_two_slice: 2 slices x 2 devices -> \(dcn=2, ici=2\) "
            r"mesh, hierarchical psum \+ grad step ok"]
    assert len(lines) == len(want), lines
    for ln, pattern in zip(lines, want):
        assert re.match(pattern, ln), (ln, pattern)
        loss = re.search(r"loss=(\S+) ok$", ln)
        if loss:
            assert np.isfinite(float(loss.group(1))) and \
                float(loss.group(1)) > 0, ln
    assert re.search(r"^\[dryrun\] all 6 sections ok in ", out, re.M)


def _jax_two_slice():
    """The JAX two-slice worker's numbers on 4 virtual devices as (dcn=2,
    ici=2): per-slice partials, the total and the hierarchical step's
    w1."""
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dcn", "ici"))
    contrib = np.arange(1, 5, dtype=np.float32).reshape(2, 2)
    shard = partial(jax.shard_map, mesh=mesh, check_vma=False)
    partials = shard(lambda v: jax.lax.psum(v, "ici"),
                     in_specs=P("dcn", "ici"), out_specs=P("dcn", None))(
        contrib)
    total = shard(lambda v: jax.lax.psum(jax.lax.psum(v, "ici"), "dcn"),
                  in_specs=P("dcn", "ici"), out_specs=P())(contrib)
    B, D = 8, 4
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(B, D)).astype(np.float32)
    ys = rng.normal(size=(B,)).astype(np.float32)

    def step(w, xb, yb):
        g = jax.grad(lambda w: jnp.sum((xb @ w - yb) ** 2))(w)
        g = jax.lax.psum(jax.lax.psum(g, "ici"), "dcn")
        return w - 0.1 * g / B

    w1 = shard(step, in_specs=(P(), P(("dcn", "ici"), None),
                               P(("dcn", "ici"))), out_specs=P())(
        jnp.zeros(D), xs, ys)
    return (sorted(np.asarray(partials).reshape(-1).tolist()),
            float(np.asarray(total).reshape(-1)[0]), np.asarray(w1))


def test_dryrun_two_slice_matches_jax(multichip):
    got = multichip[0]["two_slice"]
    partials, total, w1 = _jax_two_slice()
    assert partials == [3.0, 7.0] and total == 10.0
    assert len(got["partials"]) == len(got["total"]) == 4
    for p, t, w in zip(got["partials"], got["total"], got["w1"]):
        assert p == partials and t == total
        np.testing.assert_allclose(w, w1, atol=1e-6)


def test_dryrun_two_process(multichip):
    losses = multichip[0]["two_process"]
    assert len(losses) == 4 and len(set(losses)) == 1 and losses[0] > 0, \
        losses
