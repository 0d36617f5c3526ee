"""Ring attention: exact attention over a sequence split across ranks.

Port of ``ray_tpu/ops/ring_attention.py``. q, k and v are split along the
sequence over the P ranks of a process group (the mesh's ``seq`` axis); the
kv chunks rotate around the ring and each hop folds into an online softmax,
so memory per rank is O(S/P) while the result is exact.

Each hop is the flash kernel K1 on its chunks, which returns its ``(o,
lse)``; the pairs are merged by log-sum-exp, a small elementwise pass in
plain torch. With equal chunks the diagonal hop (a rank's own kv) is causal
with K1's top-left mask, the hops from earlier ranks are not masked, and the
hops from later ranks are fully masked and skipped: P(P+1)/2 hops over the
ring for a causal sequence, P² without the mask. The backward is a second
rotation of k and v, with fp32 dk/dv accumulators travelling with them; each
hop runs K2 and K3 with the whole row's (global) lse and δ = rowsum(dO·O),
which makes each hop's P exactly its share of the full softmax, so nothing
of the forward is recomputed but the per-hop scores inside the kernels.

CPU tensors run each hop through the kernels' plain twins
(``flash_attention_fwd_plain``, ``flash_attention_dq_plain``,
``flash_attention_dkv_plain``), which take any sequence length; CUDA
tensors launch K1, K2 and K3.

The per-rank hop schedule (:func:`ring_fwd_schedule`,
:func:`ring_bwd_schedule`) is apart from the transport: it takes the rank's
q chunk, its index, P and the kv chunks in arrival order, so one process can
feed it every rank's chunks, and :class:`_Ring` feeds it from point-to-point
sends on a real group.

Call on per-rank shards (under ``local_map``, or with ``group=``): q
[B, S_loc, H, D], k/v [B, S_loc, KVH, D].
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ray_tpu_torch.ops.cuda import flash_attention as fa


def _hop_fwd(q, k, v, causal):
    if q.device.type == "cpu":
        return fa.flash_attention_fwd_plain(q, k, v, causal)
    return fa.flash_attention_fwd(q, k, v, causal)


def _hop_bwd(q, k, v, do, lse, delta, causal):
    if q.device.type == "cpu":
        return (fa.flash_attention_dq_plain(q, k, v, do, lse, delta, causal),
                *fa.flash_attention_dkv_plain(q, k, v, do, lse, delta,
                                              causal))
    return (fa.flash_attention_dq(q, k, v, do, lse, delta, causal),
            *fa.flash_attention_dkv(q, k, v, do, lse, delta, causal))


def hop_plan(rank: int, world: int, causal: bool
             ) -> List[Tuple[int, int, bool]]:
    """The hops rank ``rank`` of ``world`` computes, as (arrival index j,
    source rank, causal mask?): the chunk that arrives j-th comes from rank
    (rank - j) mod P; under the causal mask the chunks of later ranks are
    skipped and the rank's own chunk (j = 0) is masked."""
    plan = []
    for j in range(world):
        src = (rank - j) % world
        if causal and src > rank:
            continue
        plan.append((j, src, causal and src == rank))
    return plan


def ring_fwd_schedule(q: torch.Tensor, rank: int, world: int,
                      kv_chunks: Iterable[Tuple[torch.Tensor, torch.Tensor]],
                      causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rank's forward: q [B,H,S_loc,D], the kv chunks [B,KVH,S_loc,D] in
    arrival order (every one of the P is taken from ``kv_chunks``, so that a
    transport behind it keeps turning) → (o [B,H,S_loc,D] fp32, lse
    [B,H,S_loc] fp32), the hops' pairs merged by log-sum-exp."""
    wanted = {j: c for j, _, c in hop_plan(rank, world, causal)}
    o_acc = lse_acc = None
    for j, (k, v) in enumerate(kv_chunks):
        if j not in wanted:
            continue
        o_j, lse_j = _hop_fwd(q, k, v, wanted[j])
        if o_acc is None:
            o_acc, lse_acc = o_j.float(), lse_j
            continue
        lse_new = torch.logaddexp(lse_acc, lse_j)
        o_acc = (o_acc * torch.exp(lse_acc - lse_new)[..., None]
                 + o_j.float() * torch.exp(lse_j - lse_new)[..., None])
        lse_acc = lse_new
    return o_acc, lse_acc


def ring_bwd_schedule(q, do, lse, delta, rank: int, world: int,
                      kv_chunks: Iterable[Tuple[torch.Tensor, torch.Tensor]],
                      causal: bool,
                      accumulate: Callable[[int, torch.Tensor, torch.Tensor],
                                           None]) -> torch.Tensor:
    """One rank's backward: q and dO [B,H,S_loc,D], the global lse and δ
    [B,H,S_loc] fp32, the kv chunks in arrival order → dq (fp32). Each
    hop's dk and dv (for the chunk that arrived j-th) go to
    ``accumulate(j, dk, dv)``."""
    wanted = {j: c for j, _, c in hop_plan(rank, world, causal)}
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for j, (k, v) in enumerate(kv_chunks):
        if j not in wanted:
            continue
        dq_j, dk_j, dv_j = _hop_bwd(q, k, v, do, lse, delta, wanted[j])
        dq += dq_j.float()
        accumulate(j, dk_j, dv_j)
    return dq


class _Ring:
    """The transport: the rank's chunks rotate to rank + 1 over
    point-to-point sends on ``group`` (``batch_isend_irecv``). Iterating
    yields the P chunk tuples in arrival order; with accumulators, ``add``
    sums into the travelling ones (``acc``), which after the last hop are
    back at the rank whose chunk they belong to."""

    def __init__(self, group, tensors: Sequence[torch.Tensor],
                 accumulators: Sequence[torch.Tensor] = ()):
        self.group = group
        self.rank = 0 if group is None else dist.get_rank(group)
        self.world = 1 if group is None else dist.get_world_size(group)
        self.tensors = [t.contiguous() for t in tensors]
        self.acc = [a.contiguous() for a in accumulators]

    def _shift(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        if self.world == 1 or not tensors:
            return tensors
        dst = dist.get_global_rank(self.group, (self.rank + 1) % self.world)
        src = dist.get_global_rank(self.group, (self.rank - 1) % self.world)
        recv = [torch.empty_like(t) for t in tensors]
        ops = [dist.P2POp(dist.isend, t, dst, self.group) for t in tensors]
        ops += [dist.P2POp(dist.irecv, t, src, self.group) for t in recv]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv

    def __iter__(self):
        for j in range(self.world):
            yield tuple(self.tensors)
            last = j == self.world - 1
            moved = self._shift(([] if last else self.tensors) + self.acc)
            n = 0 if last else len(self.tensors)
            if not last:
                self.tensors = moved[:n]
            self.acc = moved[n:]

    def add(self, j: int, *parts: torch.Tensor) -> None:
        del j
        for a, p in zip(self.acc, parts):
            a += p.float()


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal):
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ring = _Ring(group, (kt, vt))
        o, lse = ring_fwd_schedule(qt, ring.rank, ring.world, ring, causal)
        out = o.transpose(1, 2).to(q.dtype).contiguous()  # [B,S,H,D]
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal = group, causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        qt, kt, vt, ot, dot = (t.transpose(1, 2) for t in (q, k, v, out, do))
        delta = fa._delta(ot, dot)
        zeros = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                 for t in (kt, vt)]
        ring = _Ring(ctx.group, (kt, vt), zeros)
        dq = ring_bwd_schedule(qt, dot, lse, delta, ring.rank, ring.world,
                               ring, ctx.causal, ring.add)
        dk, dv = ring.acc
        return (dq.to(q.dtype).transpose(1, 2), dk.to(k.dtype).transpose(1, 2),
                dv.to(v.dtype).transpose(1, 2), None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   axis_name: str = "seq", causal: bool = True,
                   group: Optional[dist.ProcessGroup] = None,
                   mesh=None) -> torch.Tensor:
    """Exact attention with kv rotating around the ring of ``group`` (by
    default the ``axis_name`` sub-group of ``mesh``, or of the ambient
    mesh; a ring of one when the mesh has no such dim), differentiable.
    Per-rank shards: q [B,S_loc,H,D], k/v [B,S_loc,KVH,D] → [B,S_loc,H,D]
    in q's type; rank r holds positions [r·S_loc, (r+1)·S_loc)."""
    if group is None:
        from ray_tpu_torch.parallel.sharding import ambient_mesh

        mesh = mesh if mesh is not None else ambient_mesh()
        if mesh is None:
            raise RuntimeError("ring_attention needs a group or a mesh in "
                               "scope")
        # an axis of size 1 is not a dim of the mesh: the ring is this rank
        group = (mesh.get_group(axis_name)
                 if axis_name in mesh.mesh_dim_names else None)
    return _RingAttention.apply(q, k, v, group, causal)
