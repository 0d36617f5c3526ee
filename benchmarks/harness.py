"""The benchmark's shared parts: the manifest and the files of a cell found by
name, the environment a run keeps to, the port's runtime started and stopped
for a run, the import guard and the statistics.

Nothing here imports torch or the program: a module of the harness that
needs them imports them where it uses them."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import tempfile
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"

# Top-level module names that no process of a run may hold: the JAX stack
# and the JAX package that the port was made from. Compared whole, so that
# ``ray_tpu_torch`` (which begins with ``ray_tpu``) is not one of them.
FORBIDDEN_TOP_LEVEL = ("jax", "jaxlib", "flax", "ray_tpu")

# Published dense peaks of one H100 SXM (NVIDIA's data sheet, 700 W).
PEAK_FLOPS = {"bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12

# The runs pass tokens and small reports through the runtime's object
# store; its default (30% of the host's memory, in the session directory)
# would put an arena of ~29 GiB under $TMPDIR.
STORE_BYTES = 256 << 20


def forbidden_modules(modules: Optional[Iterable[str]] = None) -> List[str]:
    """The loaded modules whose top-level name (before the first dot) is
    one of ``FORBIDDEN_TOP_LEVEL``."""
    names = list(sys.modules) if modules is None else list(modules)
    return sorted(n for n in names
                  if n.split(".", 1)[0] in FORBIDDEN_TOP_LEVEL)


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with its files resolved by name."""
    name: str
    chips: int
    config_name: str
    config: Dict[str, Any]
    traffic_name: str
    traffic: Dict[str, Any]
    driver: str
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    limits: Dict[str, Any]


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve_cell(workload: str, manifest: Optional[Dict[str, Any]] = None,
                 root: Path = ROOT) -> Cell:
    """The cell ``workload`` of the manifest with its configuration, mix,
    driver, limits and metrics, each found by name."""
    man = load_json(root / "BENCHMARK.json") if manifest is None \
        else manifest
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    config = load_json(root / conf["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    driver = traffic["driver"]
    if not (HERE / "drivers" / f"{driver}.py").is_file():
        raise FileNotFoundError(f"mix {w['traffic']!r} names driver "
                                f"{driver!r}, which has no file")
    limits_path = HERE / "limits" / f"{workload}.json"
    limits = load_json(limits_path) if limits_path.is_file() else {}
    return Cell(
        name=workload, chips=int(w["chips"]), config_name=w["config"],
        config=config, traffic_name=w["traffic"], traffic=traffic,
        driver=driver,
        end_to_end=[m for m in man["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in man["per_layer"] if _applies(m, workload)],
        limits=limits)


def metric_reader(name: str) -> Callable[[Dict[str, Any]], Optional[float]]:
    """``read(readings)`` of ``metrics/<name>.py``: the metric's value from
    a run's readings, or None where it finds nothing to read."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmarks.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver_module(name: str):
    return importlib.import_module(f"benchmarks.drivers.{name}")


def set_environment(root: Path = ROOT) -> None:
    """Keep every cache of a run inside the checkout at a fixed path, and
    let the runtime's worker processes import the harness and the program
    from the checkout. Called before torch is imported."""
    cache = root / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    os.environ["USE_FLAX"] = "0"
    # every process of the runtime sizes its object store alike
    os.environ["RAY_TPU_TORCH_OBJECT_STORE_MEMORY_BYTES"] = str(STORE_BYTES)
    path = os.environ.get("PYTHONPATH", "")
    parts = [p for p in path.split(os.pathsep) if p]
    if str(root) not in parts:
        os.environ["PYTHONPATH"] = os.pathsep.join([str(root)] + parts)


# ---------------------------------------------------------------- runtime
def start_runtime(num_gpus: int):
    """The port's head and agent with the session under ``$TMPDIR`` (not
    the runtime's default in ``/dev/shm``), this process attached as the
    driver. Returns the node, for ``stop_runtime``."""
    import ray_tpu_torch
    from ray_tpu_torch._private.node import Node

    session = os.path.join(tempfile.gettempdir(),
                           f"bench_session_{os.getpid()}")
    node = Node(head=True, session_dir=session,
                resources={"CPU": 8.0, "GPU": float(num_gpus)},
                object_store_memory=STORE_BYTES)
    node.start()
    ray_tpu_torch.init(_node=node)
    return node


def stop_runtime(node) -> None:
    import ray_tpu_torch

    ray_tpu_torch.shutdown()
    node.stop(cleanup_session=True)


# ------------------------------------------------------------- statistics
def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100), linear between closest ranks (numpy's
    default), of a non-empty sample."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of an empty sample")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)



def sizes(conf: Dict[str, Any]) -> Dict[str, Any]:
    """A configuration file's sizes under the names the drivers and the
    references use. Published keys come from ``config``; sizes the source
    leaves out come from ``assumed``."""
    c, a = conf["config"], conf.get("assumed", {})
    heads = c["num_attention_heads"]
    out = {
        "vocab_size": c["vocab_size"], "hidden": c["hidden_size"],
        "mlp_hidden": c["intermediate_size"],
        "num_layers": c["num_hidden_layers"], "num_heads": heads,
        "num_kv_heads": c.get("num_key_value_heads", heads),
        "head_dim": c.get("head_dim") or a.get("head_dim")
        or c["hidden_size"] // heads,
        "rope_theta": float(c["rope_theta"]),
        "rms_eps": float(c["rms_norm_eps"]),
        "max_seq_len": a.get("max_seq_len", c["max_position_embeddings"]),
    }
    if "num_local_experts" in c:
        out.update(num_experts=c["num_local_experts"],
                   experts_per_token=c["num_experts_per_tok"],
                   capacity_factor=a.get("capacity_factor", 1.0),
                   aux_loss_coeff=c.get("router_aux_loss_coef", 0.0))
    return out
