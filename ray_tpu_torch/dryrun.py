"""The port's entry points: a single-device forward, and the multichip dry
run over ``torch.distributed`` ranks.

Port of the JAX package's ``__graft_entry__.py``. ``entry()`` returns a
forward step on the flagship model (the Llama decoder) and its arguments.
``dryrun_multichip(n)`` runs the JAX dry run's sections in its order, with
its asserts and ok lines, on ``n`` ranks: one process per rank (torch runs
one device per process), gloo on the CPU or NCCL on the cards:

1. ``tiny-4d-mesh``: one full train step of a tiny Llama (forward,
   backward, AdamW) on a mesh that uses every axis kind ``n`` allows (8 →
   fsdp=2, seq=2, tensor=2 with ring attention; 4 → fsdp=2, tensor=2; 2 →
   fsdp=2; else data);
2. ``pipeline-gpipe`` (``n % 4 == 0``): a GPipe train step on a
   (data, stage=4) mesh;
3. ``ddppo-data-mesh`` (``n % 2 == 0``): a PPO learner update on the data
   mesh of all the ranks;
4. ``moe-expert-mesh`` (``n % 4 == 0``): an MoE train step on a
   (data, expert=4) mesh;
5. ``two-process-mesh``: :func:`dryrun_two_process`;
6. ``two-slice-dcn``: :func:`dryrun_two_slice`;
7. ``7b-dims-ring-attn`` (``n % 8 == 0``): one train step at Llama-2-7B's
   widths (1 layer, 32 tokens, vocab 8192) on the section 1 mesh.

The two process gates always run on the CPU over gloo: 4 rank processes
grouped as 2 hosts of 2 (the JAX gates' 2 processes of 2 devices), which
rendezvous on a ``TCPStore``. Every group's store is served by the process
that launches its ranks, bound to a port the kernel picks and held until the
ranks are done; the ranks join it as clients, so no port is released and
taken again between its choice and the rendezvous.

    python -m ray_tpu_torch.dryrun [--ranks N] [--device cpu|cuda]
"""

from __future__ import annotations

import contextlib
import json
import os
import pickle
import re
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

_SECTION_TIMES: List[Tuple[str, float]] = []


def entry(device: Optional[Union[str, torch.device]] = None):
    """A forward step of the tiny Llama and its arguments (params drawn from
    seed 0, tokens [2, 128] of zeros) on ``device`` (None: the card)."""
    from ray_tpu_torch._private.device import resolve_device
    from ray_tpu_torch.models.llama import (
        LlamaConfig, init_llama, llama_forward)

    dev = resolve_device(device)
    cfg = LlamaConfig.tiny()
    params = init_llama(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tokens = torch.zeros((2, 128), dtype=torch.long, device=dev)

    def fwd(params, tokens):
        return llama_forward(params, tokens, cfg)

    return fwd, (params, tokens)


@contextlib.contextmanager
def _section(name: str, verbose: bool = True):
    """Start, ok-with-seconds and FAILED lines per section, flushed, so a
    run killed at its time limit still names the section it was in."""
    if verbose:
        print(f"[dryrun] {name}: start", flush=True)
    t0 = time.perf_counter()
    try:
        yield
    except BaseException as e:
        dt = time.perf_counter() - t0
        if verbose:
            print(f"[dryrun] {name}: FAILED after {dt:.1f}s "
                  f"({type(e).__name__}: {e})", flush=True)
        raise
    dt = time.perf_counter() - t0
    _SECTION_TIMES.append((name, dt))
    if verbose:
        print(f"[dryrun] {name}: ok in {dt:.1f}s", flush=True)


@contextlib.contextmanager
def _rendezvous():
    """A ``TCPStore`` served from this process on a port the kernel picks,
    for the length of the block: its ``host:port``."""
    store = dist.TCPStore("localhost", 0, is_master=True,
                          wait_for_workers=False)
    try:
        yield f"localhost:{store.port}"
    finally:
        del store


def _join_group(backend: str, coord: str, world: int, rank: int) -> None:
    """Join the ``world``-rank group whose store serves at ``coord``."""
    host, port = coord.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), world, is_master=False)
    dist.init_process_group(backend, store=store, world_size=world,
                            rank=rank)


# ------------------------------------------------------ the ranks' sections

def _mesh_config(n: int):
    """Section 1's mesh: every axis kind that ``n`` allows."""
    from ray_tpu_torch.parallel.mesh import MeshConfig

    if n % 8 == 0:
        return MeshConfig(data=-1, fsdp=2, seq=2, tensor=2)
    if n % 4 == 0:
        return MeshConfig(data=-1, fsdp=2, tensor=2)
    if n % 2 == 0:
        return MeshConfig(data=-1, fsdp=2)
    return MeshConfig(data=-1)


def _llama_step(cfg, mc, batch_size: int, seq_len: int, dev) -> float:
    """One train step of ``cfg`` (adamw(1e-3), params from seed 0) on
    ``mc``'s mesh over every rank, on a batch of ones: its loss."""
    from ray_tpu_torch.models.llama import (
        init_llama, llama_logical_axes, llama_loss)
    from ray_tpu_torch.parallel.mesh import create_mesh
    from ray_tpu_torch.parallel.optim import adamw
    from ray_tpu_torch.parallel.sharding import compat_mesh_ctx
    from ray_tpu_torch.parallel.train_step import (
        create_train_state, make_train_step)

    mesh = create_mesh(mc, device=dev)
    tx = adamw(1e-3)
    with compat_mesh_ctx(mesh):
        state = create_train_state(lambda g: init_llama(cfg, g, g.device),
                                   tx, mesh, llama_logical_axes(cfg),
                                   device=dev)
        step = make_train_step(lambda p, b: llama_loss(p, b, cfg), tx, mesh,
                               batch_logical_axes=("batch", "seq"))
        tokens = torch.ones((batch_size, seq_len + 1), dtype=torch.long,
                            device=dev)
        state, metrics = step(state, {"inputs": tokens[:, :-1],
                                      "targets": tokens[:, 1:]})
        return float(metrics["loss"])


def _multichip_sections(n: int, dev: torch.device, sections, verbose: bool
                        ) -> None:
    """The dry run's sections that run on the ranks, in order; rank 0
    prints."""
    import dataclasses

    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    from ray_tpu_torch.parallel.optim import adamw

    def say(line: str) -> None:
        if verbose:
            print(line, flush=True)

    mc = _mesh_config(n)
    sizes = mc.resolve(n)
    tx = adamw(1e-3)

    if "mesh" in sections:
        with _section("tiny-4d-mesh", verbose):
            cfg = LlamaConfig.tiny(vocab_size=256)
            if sizes["seq"] > 1:
                cfg = dataclasses.replace(cfg, attn_impl="ring_seq")
            batch_size = max(8, 2 * sizes["data"] * sizes["fsdp"])
            loss = _llama_step(cfg, mc, batch_size, 64 * sizes["seq"], dev)
            assert loss > 0, f"bad loss {loss}"
            say(f"dryrun_multichip({n}): mesh={sizes} loss={loss:.4f} ok")

    if "pipeline" in sections and n % 4 == 0:
        with _section("pipeline-gpipe", verbose):
            from ray_tpu_torch.parallel.pipeline import (
                init_stage_params, make_pipeline_train_step)

            pp_mc = MeshConfig(data=-1, stage=4)
            pp_mesh = create_mesh(pp_mc, device=dev)
            D = 16

            def pp_init(g):
                return {"w": torch.randn((D, D), generator=g,
                                         device=g.device) * 0.1,
                        "b": torch.randn((D,), generator=g,
                                         device=g.device) * 0.1}

            def pp_stage(p, h):
                return torch.tanh(h @ p["w"] + p["b"])

            pp_params = init_stage_params(pp_init, 4, pp_mesh, seed=0,
                                          device=dev)
            pp_step = make_pipeline_train_step(
                pp_stage, lambda y, t: torch.mean((y - t) ** 2), tx,
                pp_mesh, pp_params, num_microbatches=4)
            # rows must split into 4 microbatches across the data shards
            pp_rows = 4 * 2 * pp_mc.resolve(n)["data"]
            x = torch.ones((pp_rows, D), device=dev)
            (pp_params, _), pp_metrics = pp_step(
                (pp_params, tx(pp_params)),
                (x, 0.3 * torch.ones((pp_rows, D), device=dev)))
            pp_loss = float(pp_metrics["loss"])
            assert pp_loss > 0
            say(f"dryrun_multichip({n}): PP mesh={pp_mc.resolve(n)} "
                f"loss={pp_loss:.4f} ok")

    if "ddppo" in sections and n % 2 == 0:
        with _section("ddppo-data-mesh", verbose):
            from ray_tpu_torch.rllib.core.learner import PPOLearner
            from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec

            learner = PPOLearner(
                RLModuleSpec(obs_dim=8, action_dim=4, discrete=True),
                {"lr": 3e-4, "num_epochs": 1, "seed": 0}, use_mesh=True,
                device=dev)
            assert learner._mesh is not None and \
                learner._mesh.size() == n
            B = 16 * n
            rng = np.random.default_rng(0)
            ddppo_batch = {
                "obs": rng.normal(size=(B, 8)).astype(np.float32),
                "actions": rng.integers(0, 4, B).astype(np.int32),
                "logp": np.full(B, -1.3, np.float32),
                "advantages": rng.normal(size=B).astype(np.float32),
                "value_targets": rng.normal(size=B).astype(np.float32),
            }
            ddppo_metrics = learner.update(ddppo_batch)
            loss_v = float(ddppo_metrics["total_loss"])
            assert np.isfinite(loss_v), ddppo_metrics
            mesh_shape = dict(zip(learner._mesh.mesh_dim_names,
                                  learner._mesh.shape))
            say(f"dryrun_multichip({n}): DD-PPO data mesh={mesh_shape} "
                f"loss={loss_v:.4f} ok")

    if "moe" in sections and n % 4 == 0:
        with _section("moe-expert-mesh", verbose):
            from ray_tpu_torch.models.moe import (
                MoEConfig, init_moe, moe_logical_axes, moe_loss)
            from ray_tpu_torch.parallel.sharding import compat_mesh_ctx
            from ray_tpu_torch.parallel.train_step import (
                create_train_state, make_train_step)

            ep_mc = MeshConfig(data=-1, expert=4)
            ep_mesh = create_mesh(ep_mc, device=dev)
            moe_cfg = MoEConfig.tiny()
            with compat_mesh_ctx(ep_mesh):
                state = create_train_state(
                    lambda g: init_moe(moe_cfg, g, g.device), tx, ep_mesh,
                    moe_logical_axes(moe_cfg), device=dev)
                step = make_train_step(
                    lambda p, b: moe_loss(p, b, moe_cfg), tx, ep_mesh,
                    batch_logical_axes=("batch", "seq"))
                toks = torch.ones((2 * ep_mc.resolve(n)["data"], 33),
                                  dtype=torch.long, device=dev)
                state, metrics = step(state, {"inputs": toks[:, :-1],
                                              "targets": toks[:, 1:]})
                moe_loss_val = float(metrics["loss"])
            assert moe_loss_val > 0
            say(f"dryrun_multichip({n}): MoE EP mesh={ep_mc.resolve(n)} "
                f"loss={moe_loss_val:.4f} ok")

    if "7b" in sections and n % 8 == 0:
        with _section("7b-dims-ring-attn", verbose):
            # Llama-2-7B's core widths on the full (fsdp, seq, tensor) mesh
            # with ring attention; depth cut to 1 layer, 32 tokens, vocab
            # 8192, as the JAX section cuts them
            cfg7b = LlamaConfig(
                vocab_size=8192, hidden=4096, mlp_hidden=11008,
                num_layers=1, num_heads=32, num_kv_heads=32, head_dim=128,
                max_seq_len=256, remat=True, attn_impl="ring_seq",
                loss_chunk=16)
            b7 = max(2, sizes["data"] * sizes["fsdp"])
            loss7b = _llama_step(cfg7b, mc, b7, 32, dev)
            assert loss7b > 0, f"bad 7B-dims loss {loss7b}"
            say(f"dryrun_multichip({n}): 7B-dims mesh={sizes} "
                f"hidden={cfg7b.hidden} heads={cfg7b.num_heads} "
                f"loss={loss7b:.4f} ok")


def _rank_main(rank: int, world: int, coord: str, device_type: str,
               sections, out_path: str) -> None:
    """One rank of the dry run: join the group, run the sections, and on
    rank 0 write their times to ``out_path``."""
    from ray_tpu_torch._private.device import resolve_device

    if device_type == "cuda":
        torch.cuda.set_device(rank)
        dev = resolve_device(torch.device("cuda", rank))
    else:
        torch.set_num_threads(1)
        dev = resolve_device("cpu")
    _join_group("nccl" if device_type == "cuda" else "gloo", coord, world,
                rank)
    try:
        _multichip_sections(world, dev, sections, verbose=rank == 0)
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(list(_SECTION_TIMES), f)
    finally:
        dist.destroy_process_group()


def _run_ranks(n: int, device_type: str, sections) -> List[Tuple[str, float]]:
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp, _rendezvous() as coord:
        out = os.path.join(tmp, "times.pkl")
        mp.start_processes(_rank_main, args=(n, coord, device_type,
                                             tuple(sections), out),
                           nprocs=n, start_method="spawn")
        with open(out, "rb") as f:
            return pickle.load(f)


def dryrun_multichip(n_devices: int, *,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> Dict[str, list]:
    """The dry run on ``n_devices`` ranks (one process each; ``device``
    None is the CUDA cards, one a rank, and raises without enough of them;
    ``"cpu"`` runs gloo ranks). Section order is the JAX gate's: cheap gates
    first, the 7B-widths section last. Returns ``{"sections": [(name,
    seconds), ...], "two_process": its losses, "two_slice": its
    numbers}``."""
    from ray_tpu_torch._private.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"{n_devices} ranks need {n_devices} cards; "
                           f"{torch.cuda.device_count()} visible")
    del _SECTION_TIMES[:]
    _SECTION_TIMES.extend(_run_ranks(n_devices, dev.type,
                                     ("mesh", "pipeline", "ddppo", "moe")))
    with _section("two-process-mesh"):
        losses = dryrun_two_process()
    with _section("two-slice-dcn"):
        slices = dryrun_two_slice()
    if n_devices % 8 == 0:
        _SECTION_TIMES.extend(_run_ranks(n_devices, dev.type, ("7b",)))
    total = sum(dt for _, dt in _SECTION_TIMES)
    print(f"[dryrun] all {len(_SECTION_TIMES)} sections ok in {total:.1f}s: "
          + ", ".join(f"{n}={dt:.1f}s" for n, dt in _SECTION_TIMES),
          flush=True)
    return {"sections": list(_SECTION_TIMES), "two_process": losses,
            "two_slice": slices}


# ------------------------------------------------- the two process gates

HOSTS, LOCAL = 2, 2  # 2 "hosts" (the JAX gates' processes) of 2 ranks


def _join_hosts(host: int, local_rank: int, coord: str) -> int:
    """Join the 4-rank gloo group over the TCPStore at ``coord`` as
    ``local_rank`` of ``host``; check that every rank is where it says.
    Returns the global rank."""
    torch.set_num_threads(1)
    rank = host * LOCAL + local_rank
    _join_group("gloo", coord, HOSTS * LOCAL, rank)
    where = torch.tensor([host, local_rank])
    seen = [torch.empty_like(where) for _ in range(HOSTS * LOCAL)]
    dist.all_gather(seen, where)
    want = [[h, r] for h in range(HOSTS) for r in range(LOCAL)]
    if [s.tolist() for s in seen] != want:
        raise RuntimeError(f"two-host group malformed: ranks report "
                           f"{[s.tolist() for s in seen]}, want {want}")
    return rank


def _two_process_worker(host: int, local_rank: int, coord: str) -> None:
    """One rank of the two-process gate: one full sharded train step of the
    tiny Llama on a (data=2, fsdp=2) mesh over both hosts' ranks."""
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.parallel.mesh import MeshConfig

    rank = _join_hosts(host, local_rank, coord)
    try:
        mc = MeshConfig(data=-1, fsdp=2)
        loss = _llama_step(LlamaConfig.tiny(vocab_size=256), mc, 4, 64,
                           torch.device("cpu"))
        assert loss > 0, f"bad two-proc loss {loss}"
        print(f"two-proc-worker rank={rank} host={host} local_rank="
              f"{local_rank}: mesh={mc.resolve(dist.get_world_size())} "
              f"global_devices={dist.get_world_size()} loss={loss:.4f} ok",
              flush=True)
    finally:
        dist.destroy_process_group()


def _two_slice_worker(host: int, local_rank: int, coord: str) -> None:
    """One rank of the two-slice gate. Each host is one slice; the mesh is
    (dcn=slices, ici=ranks of a slice), the host boundary on the outer
    axis. (1) The hierarchical sum: rank (i, j) contributes i·LOCAL + j + 1;
    the sum over ``ici`` (inside a slice) gives each slice's partial, the
    sum of those over ``dcn`` the global total. (2) The hierarchical
    gradient step: the batch split over (dcn, ici), each rank's gradient of
    its rows' summed squared error reduced over ``ici``, then over
    ``dcn``."""
    from torch.distributed.device_mesh import init_device_mesh

    rank = _join_hosts(host, local_rank, coord)
    try:
        mesh = init_device_mesh("cpu", (HOSTS, LOCAL),
                                mesh_dim_names=("dcn", "ici"))
        ici, dcn = mesh.get_group("ici"), mesh.get_group("dcn")
        contrib = np.arange(1, HOSTS * LOCAL + 1,
                            dtype=np.float32).reshape(HOSTS, LOCAL)
        v = torch.tensor([contrib[host, local_rank]])
        dist.all_reduce(v, group=ici)  # inside the slice
        parts = [torch.empty_like(v) for _ in range(HOSTS)]
        dist.all_gather(parts, v, group=dcn)
        partials = torch.cat(parts).tolist()
        dist.all_reduce(v, group=dcn)  # across the slices
        total = float(v.item())
        want_partials = contrib.sum(axis=1)
        want_total = float(contrib.sum())
        if not np.allclose(sorted(partials), sorted(want_partials.tolist())):
            raise RuntimeError(f"per-slice ICI partials wrong: {partials} "
                               f"!= {want_partials}")
        if total != want_total:
            raise RuntimeError(
                f"hierarchical total wrong: {total} != {want_total} (a "
                "group that is not global would reduce only its own slice)")

        B, D = 8, 4
        rng = np.random.default_rng(0)
        xs = rng.normal(size=(B, D)).astype(np.float32)
        ys = rng.normal(size=(B,)).astype(np.float32)
        w0 = np.zeros(D, np.float32)
        lr = 0.1
        rows = slice(rank * B // (HOSTS * LOCAL),
                     (rank + 1) * B // (HOSTS * LOCAL))
        w = torch.from_numpy(w0.copy()).requires_grad_(True)
        xb, yb = torch.from_numpy(xs[rows]), torch.from_numpy(ys[rows])
        torch.sum((xb @ w - yb) ** 2).backward()  # the local shard's sum
        g = w.grad.clone()
        dist.all_reduce(g, group=ici)  # slice-internal reduction
        dist.all_reduce(g, group=dcn)  # one cross-slice all-reduce
        w1 = (w.detach() - lr * g / B).numpy()
        want = w0 - lr * (2 * xs.T @ (xs @ w0 - ys)) / B
        if not np.allclose(w1, want, atol=1e-5):
            raise RuntimeError(
                f"hierarchical grad step wrong: {w1} != {want}")
        print(f"two-slice-worker rank={rank} host={host} local_rank="
              f"{local_rank}: mesh={{'dcn': {HOSTS}, 'ici': {LOCAL}}} "
              f"partials={sorted(partials)} total={total} "
              f"w1={json.dumps(w1.tolist())} grad-step ok", flush=True)
    finally:
        dist.destroy_process_group()


def _spawn_entry_workers(flag: str, timeout: float = 900) -> List[str]:
    """Launch the 4 rank processes of a two-host gate (``python -m
    ray_tpu_torch.dryrun <flag> <host> <local_rank> <coord>``) and join
    them, each of whose output must have its ok line."""
    with _rendezvous() as coord:
        return _run_entry_workers(flag, coord, timeout)


def _run_entry_workers(flag: str, coord: str, timeout: float) -> List[str]:
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.dryrun", flag, str(host),
             str(local_rank), coord],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for host in range(HOSTS) for local_rank in range(LOCAL)]
    outs = []
    try:
        for rank, p in enumerate(procs):
            try:
                out, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"worker {rank} ({flag}) timed out")
            outs.append(out)
            if p.returncode != 0:
                raise RuntimeError(
                    f"worker {rank} ({flag}) rc={p.returncode}:"
                    f"\n{out[-4000:]}")
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.wait()
    return outs


def _ok_lines(outs: List[str], tag: str) -> List[str]:
    lines = []
    for rank, out in enumerate(outs):
        found = [ln for ln in out.splitlines()
                 if ln.startswith(f"{tag} rank={rank} ") and ln.endswith("ok")]
        if not found:
            raise RuntimeError(f"{tag} {rank} missing ok line:\n"
                               f"{out[-4000:]}")
        lines.append(found[-1])
    return lines


def dryrun_two_slice() -> Dict[str, list]:
    """Two-slice (DCN) gate: 2 hosts of 2 gloo ranks form a (dcn=2, ici=2)
    mesh; the hierarchical sum and the hierarchical-gradient step are
    checked on every rank. Returns every rank's partials, total and w1."""
    lines = _ok_lines(_spawn_entry_workers("--two-slice-worker"),
                      "two-slice-worker")
    got: Dict[str, list] = {"partials": [], "total": [], "w1": []}
    for ln in lines:
        got["partials"].append(json.loads(
            re.search(r"partials=(\[[^\]]*\])", ln).group(1)))
        got["total"].append(float(re.search(r"total=(\S+)", ln).group(1)))
        got["w1"].append(json.loads(
            re.search(r"w1=(\[[^\]]*\])", ln).group(1)))
    print("dryrun_two_slice: 2 slices x 2 devices -> (dcn=2, ici=2) mesh, "
          "hierarchical psum + grad step ok", flush=True)
    return got


def dryrun_two_process() -> List[float]:
    """Process-boundary gate: 2 hosts of 2 gloo ranks (4 OS processes)
    form one global group and run one full sharded train step. Returns
    every rank's loss."""
    lines = _ok_lines(_spawn_entry_workers("--two-proc-worker"),
                      "two-proc-worker")
    losses = [float(re.search(r"loss=(\S+)", ln).group(1)) for ln in lines]
    print("dryrun_two_process: 2 procs x 2 devices -> one 4-device global "
          "mesh, full train step ok", flush=True)
    return losses


def main(argv: List[str]) -> int:
    if argv[:1] == ["--two-proc-worker"]:
        _two_process_worker(int(argv[1]), int(argv[2]), argv[3])
        return 0
    if argv[:1] == ["--two-slice-worker"]:
        _two_slice_worker(int(argv[1]), int(argv[2]), argv[3])
        return 0
    import argparse

    ap = argparse.ArgumentParser(prog="python -m ray_tpu_torch.dryrun")
    ap.add_argument("--ranks", type=int, default=None,
                    help="number of ranks (default: the visible cards, or "
                         "8 on the CPU)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (gloo ranks)")
    args = ap.parse_args(argv)
    fn, fargs = entry(args.device)
    with torch.no_grad():
        out = fn(*fargs)
    print("entry ok:", tuple(out.shape), flush=True)
    n = args.ranks
    if n is None:
        n = torch.cuda.device_count() if args.device != "cpu" else 8
    dryrun_multichip(n, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
