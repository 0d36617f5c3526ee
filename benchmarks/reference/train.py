"""Plain training steps for the references: float32 autograd and AdamW as
``optax.adamw`` states it, p <- p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p),
with the readings the train driver compares: each step's loss, each leaf's
first gradient norm, and each leaf's change after the steps."""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Sequence, Tuple

import torch

from benchmarks.reference.rounding import exact_float32


def named_leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(dotted name, leaf) of a nested dict, in its order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def run_steps(params: Dict, loss_fn: Callable[[Dict, Any], torch.Tensor],
              batches: Sequence[Any], lr: float, b1: float = 0.9,
              b2: float = 0.999, eps: float = 1e-8, wd: float = 1e-4
              ) -> Dict[str, Any]:
    """One AdamW step per batch on ``params`` (float32 leaves, updated in
    place). Returns the losses, the first step's grad norm per leaf and the
    norm of each leaf's change over all the steps."""
    with exact_float32():
        return _run(params, loss_fn, batches, lr, b1, b2, eps, wd)


def _run(params, loss_fn, batches, lr, b1, b2, eps, wd):
    leaves = list(named_leaves(params))
    # the start on the host: a full fine-tune's params, grads and two
    # moments already fill most of the card
    start = {n: p.detach().to("cpu", copy=True) for n, p in leaves}
    m = {n: torch.zeros_like(p) for n, p in leaves}
    v = {n: torch.zeros_like(p) for n, p in leaves}
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    for t, batch in enumerate(batches, start=1):
        for _, p in leaves:
            p.requires_grad_(True)
            p.grad = None
        loss = loss_fn(params, batch)
        loss.backward()
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for n, p in leaves:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                if t == 1:
                    grad_norms[n] = float(g.norm())
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                p.grad = None
                del g
                denom = (v[n] / (1 - b2 ** t)).sqrt_().add_(eps)
                p.mul_(1 - lr * wd)
                p.addcdiv_(m[n], denom, value=-lr / (1 - b1 ** t))
                del denom
    with torch.no_grad():
        change = {n: float((p - start[n].to(p.device)).norm())
                  for n, p in leaves}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}


def _median(vals: List[float]) -> float:
    vals = sorted(vals)
    k = len(vals) // 2
    return vals[k] if len(vals) % 2 else 0.5 * (vals[k - 1] + vals[k])


def leaf_gaps(got: Dict[str, float], want: Dict[str, float]
              ) -> Dict[str, float]:
    """Each leaf's gap |got - want| over the larger of want's norm of that
    leaf and of the median leaf. Leaves whose reference norm is under a
    thousandth of the median leaf's are left out: they move by round-off
    alone."""
    median = _median(list(want.values()))
    return {n: abs(got[n] - w) / max(w, median) for n, w in want.items()
            if w >= 1e-3 * median}


def leaf_gap(got: Dict[str, float], want: Dict[str, float]
             ) -> Tuple[float, str]:
    """The worst leaf's gap (``leaf_gaps``) and its name."""
    gaps = leaf_gaps(got, want)
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf
