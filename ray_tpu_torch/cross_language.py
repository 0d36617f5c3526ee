# Copied from ray_tpu/cross_language.py (ray_tpu -> ray_tpu_torch, RAY_TPU_ -> RAY_TPU_TORCH_).
"""Cross-language calls (reference: python/ray/cross_language.py — typed
function descriptors address non-Python targets by name; args/returns are
msgpack, never pickle).

Python -> C++: ``cpp_function("name").remote(args...)`` submits a task
whose lease asks for ``runtime_env={"language": "cpp"}``; the agent routes
it to an externally-registered C++ TaskWorker (cpp/include/ray_tpu/
worker.hpp), which executes the registered native function and returns a
msgpack payload.

C++ -> Python runs the other way through the same plane: the C++ driver
client's SubmitPyTask names a Python function "pkg.mod:qualname"
(cpp/src/client.cc, function_table.XLANG_PYREF_FID).
"""

from __future__ import annotations

from typing import Dict, Optional


class _XlangFunction:
    def __init__(self, name: str, language: str,
                 resources: Optional[Dict[str, float]] = None,
                 num_returns: int = 1):
        self._name = name
        self._language = language
        self._resources = resources
        self._num_returns = num_returns

    def options(self, *, resources: Optional[Dict[str, float]] = None,
                num_returns: int = 1) -> "_XlangFunction":
        return _XlangFunction(self._name, self._language,
                              resources, num_returns)

    def remote(self, *args):
        from ray_tpu_torch._private import worker as worker_mod

        w = worker_mod.global_worker
        if w is None:
            raise RuntimeError("ray_tpu_torch.init() first")
        refs = w.submit_xlang_task(
            self._name, args, language=self._language,
            resources=self._resources, num_returns=self._num_returns)
        return refs[0] if self._num_returns == 1 else refs

    def __repr__(self):
        return f"<{self._language} function {self._name!r}>"


def cpp_function(name: str) -> _XlangFunction:
    """Handle to a C++ function registered in a TaskWorker
    (reference: ray.cross_language.cpp_function)."""
    return _XlangFunction(name, "cpp")
