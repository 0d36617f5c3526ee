"""The deployment the serve driver runs: the program's ``LlamaGenerator``
with the harness's hooks, and nothing of the serving path changed.

The hooks run in the replica, the process that holds the card: a warm-up
of every (batch, length) shape the cell's traffic can make, the profiler
around the traced window, and a probe of the process's peak device memory,
its card and the modules it loaded."""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Any, Dict, Optional, Sequence

import torch

from ray_tpu_torch.models.llama import llama_forward
from ray_tpu_torch.serve.llm import LlamaGenerator

from benchmarks.harness import forbidden_modules
from benchmarks.trace import Tracer


class BenchGenerator(LlamaGenerator):

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._tracer = Tracer()
        self._summary: Dict[str, Any] = {}
        self._reducer = None
        self._started = threading.Event()
        self._stop_trace = threading.Event()
        self._reduce = threading.Event()

    def warm_up(self, batches: Sequence[int], lengths: Sequence[int],
                adapter: str) -> Dict[str, Any]:
        """One forward at each (batch, padded length) the engine can
        dispatch, through the first layer only: every layer has the same
        shapes, so each kernel and product the window runs meets its shape
        here once. Then the peak memory count is reset."""
        cut = dataclasses.replace(self._cfg, num_layers=1)
        params = dict(self._params)
        params["layers"] = {k: v[:1] for k, v in self._params["layers"].items()}
        lora = self._adapter(adapter)
        lora1 = None if lora is None else {"layers": {
            k: {"a": ab["a"][:1], "b": ab["b"][:1]}
            for k, ab in lora["layers"].items()}}
        n = 0
        with torch.inference_mode():
            for b in batches:
                for s in lengths:
                    tokens = torch.zeros((b, s), dtype=torch.int64,
                                         device=self.device)
                    logits = llama_forward(params, tokens, cut, lora=lora1,
                                           lora_cfg=self._lcfg)
                    logits[:, -1].argmax(dim=-1).tolist()
                    n += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        return {"shapes": n}

    # The profiler starts, stops and is reduced in one thread of its own
    # (the reduction waits until the driver asks, after the window):
    # Kineto's host-side state belongs to the thread that started it. It
    # then sees the card's kernels and every thread's CUDA runtime calls,
    # but not the host operations of the engine's stepper thread.
    def trace_start(self) -> None:
        if self._reducer is None:
            self._reducer = threading.Thread(
                target=self._trace, name="bench-trace", daemon=True)
            self._reducer.start()
            self._started.wait(60)

    def trace_stop(self) -> None:
        self._stop_trace.set()

    def _trace(self) -> None:
        try:
            self._tracer.start()
            self._started.set()
            self._stop_trace.wait()
            stop_s = self._tracer.finish()
            # reduced once the driver asks, after the window
            self._reduce.wait()
            self._summary.update(self._tracer.summary())
            self._summary["stop_s"] = stop_s
        except Exception as e:  # noqa: BLE001 — reported to the caller
            self._summary["error"] = repr(e)
        finally:
            self._started.set()

    def trace_summary(self) -> Optional[Dict[str, Any]]:
        """The trace's summary once reduced, else None; the first call
        starts the reduction."""
        self._reduce.set()
        if self._reducer is None or self._reducer.is_alive():
            return None
        return dict(self._summary)

    def probe(self) -> Dict[str, Any]:
        on = self.device.type == "cuda"
        if on:
            torch.cuda.synchronize()
        return {
            "pid": os.getpid(),
            "device": torch.cuda.get_device_name(0) if on else "cpu",
            "memory_peak_bytes": torch.cuda.max_memory_allocated()
            if on else 0,
            "forbidden": forbidden_modules(),
        }
