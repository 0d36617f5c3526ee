"""The one generator of inputs, driven by a mix's data file: requests for
the serve driver, batches of tokens for the train driver.

A mix fixes a pool of request sizes (prompt length, output length, adapter)
that is the same for every seed: the lengths are the quantiles of the mix's
distributions at evenly spaced probabilities, paired and ordered by fixed
permutations, and the adapters are dealt by their popularity. The seed draws
the tokens. The order is fixed too: in a closed loop the order decides which
requests share a batch, and with it the padded length of every step, so a
seed that reordered the pool changed the work (by a quarter of the step
time on the H100)."""

from __future__ import annotations

import statistics
from typing import Any, Dict, List

import numpy as np


def _quantiles(spec: Dict[str, Any], n: int) -> List[int]:
    probs = [(i + 0.5) / n for i in range(n)]
    if spec["dist"] == "lognormal":
        z = statistics.NormalDist()
        vals = [spec["median"] * np.exp(spec["sigma"] * z.inv_cdf(p))
                for p in probs]
    elif spec["dist"] == "uniform":
        vals = [spec["min"] + p * (spec["max"] - spec["min"]) for p in probs]
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    lo, hi = spec.get("min", 1), spec.get("max", 1 << 30)
    return [int(min(max(round(v), lo), hi)) for v in vals]


def _adapters(spec: Dict[str, Any], n: int) -> List[str]:
    """n adapter names dealt by Zipf popularity: the k-th name (from 1) gets
    a share proportional to k**-s, rounded by largest remainder."""
    names = spec["names"]
    w = np.array([(k + 1) ** -float(spec.get("zipf_s", 0.0))
                  for k in range(len(names))])
    share = w / w.sum() * n
    counts = np.floor(share).astype(int)
    for k in np.argsort(-(share - counts))[:n - counts.sum()]:
        counts[k] += 1
    return [name for name, c in zip(names, counts) for _ in range(c)]


def request_pool(mix: Dict[str, Any]) -> List[Dict[str, Any]]:
    """The mix's requests as sizes, the same for every seed."""
    n = int(mix["pool"])
    prompts = _quantiles(mix["prompt_len"], n)
    outputs = _quantiles(mix["output_len"], n)
    fixed = np.random.default_rng(0)
    outputs = [outputs[i] for i in fixed.permutation(n)]
    adapters = [_adapters(mix["adapters"], n)[i] for i in fixed.permutation(n)]
    return [{"prompt_len": p, "max_new": o, "adapter": a}
            for p, o, a in zip(prompts, outputs, adapters)]


def requests(mix: Dict[str, Any], seed: int, vocab: int
             ) -> List[Dict[str, Any]]:
    """The pool in its fixed order, each request with its prompt's tokens
    drawn from the seed."""
    rng = np.random.default_rng(seed)
    pool = request_pool(mix)
    out = []
    for i in np.random.default_rng(1).permutation(len(pool)):
        r = dict(pool[i])
        r["prompt"] = rng.integers(0, vocab, r["prompt_len"]).tolist()
        out.append(r)
    return out


def train_batches(mix: Dict[str, Any], seed: int, vocab: int
                  ) -> List[np.ndarray]:
    """The mix's ``batches`` distinct batches of next-token pairs, token
    ids [batch, seq + 1] each from its own stream of the seed: inputs are
    [:, :-1], targets [:, 1:]. A run feeds them in turn."""
    return [np.random.default_rng([seed, i]).integers(
        0, vocab, (mix["batch"], mix["seq"] + 1))
        for i in range(mix["batches"])]
