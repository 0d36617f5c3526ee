"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles, on its own, into a shared library with a
plain C interface, ``build/<name>-<hash>.so``, where the hash covers the
source and the compiler flags. A library is built at its first use (or by
:func:`build_all`, which starts one ``nvcc`` per source, all together) and
reused while its source is unchanged. Importing this module needs no
``nvcc``; a build without one raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

_HERE = Path(__file__).resolve().parent
SRC_DIR = _HERE / "csrc"
BUILD_DIR = _HERE / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc not found (not on PATH, nor under $CUDA_HOME/bin): the CUDA "
        "kernels of ray_tpu_torch are built from source at first use")


def _target(name: str) -> Tuple[Path, Path]:
    src = SRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return src, BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; None when the library is already built."""
    src, out = _target(name)
    if out.exists():
        return None
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {name} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a torn .so
    return log


def build_all() -> Dict[str, Tuple[float, str]]:
    """Build every kernel source, one nvcc each, all started together.
    Returns {name: (seconds, compiler log)}; the log holds ptxas's
    register and shared-memory report."""
    t0 = time.perf_counter()
    with _lock:
        jobs = {p.stem: _start(p.stem) for p in sorted(SRC_DIR.glob("*.cu"))}
        done = {}
        for name, job in jobs.items():
            log = _finish(name, job) if job else "already built"
            done[name] = (time.perf_counter() - t0, log)
        return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            job = _start(name)
            if job is not None:
                _finish(name, job)
            _libs[name] = ctypes.CDLL(str(_target(name)[1]))
        return _libs[name]
