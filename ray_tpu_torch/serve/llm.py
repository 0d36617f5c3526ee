"""LoRA-adapter llama generation on the continuous batching engine.

Port of ``ray_tpu/serve/llm.py``'s ``LlamaGenerator``: one frozen base model,
per-request LoRA adapters multiplexed by model id, greedy decode driven step
by step by :class:`~ray_tpu_torch.serve._private.engine.ContinuousBatchingEngine`
so mixed-length generations share the batch. Each step pads the live rows to
an allowed batch size and to a multiple of ``seq_bucket`` and recomputes the
full prefix (no kv cache yet). With ``seq_bucket`` a multiple of 128 and a
head_dim of 128, every attention call of a step on the card runs the CUDA
flash kernel.

Usage::

    from ray_tpu_torch.serve.llm import LlamaGenerator
    gen = LlamaGenerator(config="llama2_7b", seq_bucket=128)  # on the card
    toks = list(gen({"prompt": [3, 5, 7], "max_new": 8, "adapter": "a1"}))
    gen.engine.shutdown()

The Serve deployment around it (``build_llama_app``) and the multiplexed
model id of the request context wait for the port of the Serve control
plane; the adapter comes from ``payload["adapter"]``.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import zlib
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.llama import (
    LlamaConfig, LoraConfig, init_llama, init_lora, llama_forward)
from ray_tpu_torch.serve._private.engine import ContinuousBatchingEngine


class LlamaGenerator:
    """Deployment callable: streaming greedy generation with multiplexed
    LoRA adapters, continuously batched. ``device=None`` is the CUDA card;
    pass ``device="cpu"`` to run on the CPU."""

    def __init__(self, config: Union[str, LlamaConfig] = "tiny",
                 lora_rank: int = 4,
                 max_batch_size: int = 4,
                 allowed_batch_sizes: Optional[Sequence[int]] = (1, 2, 4),
                 max_new_tokens: int = 16, seq_bucket: int = 32,
                 max_adapters: int = 4, seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self._cfg = getattr(LlamaConfig, config)() \
            if isinstance(config, str) else config
        # adapt only the attention q/v projections: the cheap standard
        # LoRA target set, and enough for adapters to produce distinct
        # generations
        self._lcfg = LoraConfig(rank=lora_rank, targets=("wq", "wv"))
        # matrices in the activation type: the value the reference multiplies
        # after its per-product cast, at half the fp32 footprint
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self._params = init_llama(
            dataclasses.replace(self._cfg, param_dtype=self._cfg.dtype),
            gen, self.device)
        self.max_new_tokens = max_new_tokens
        self.seq_bucket = max(8, int(seq_bucket))
        self._max_adapters = max_adapters
        self._adapters: "collections.OrderedDict[str, Any]" = \
            collections.OrderedDict()
        self._adapter_lock = threading.Lock()
        self.engine = ContinuousBatchingEngine(
            self._step, prefill_fn=self._prefill,
            max_batch_size=max_batch_size,
            allowed_batch_sizes=allowed_batch_sizes,
            name="llama")

    # ------------------------------------------------------------- adapters
    def _adapter(self, model_id: str):
        """Deterministic per-id LoRA tensors, LRU-cached (the sync-path
        analog of ``@serve.multiplexed`` — loads happen in the stepper
        thread, so the cache is lock-guarded)."""
        if not model_id:
            return None
        with self._adapter_lock:
            if model_id in self._adapters:
                self._adapters.move_to_end(model_id)
                return self._adapters[model_id]
        gen = torch.Generator(device=self.device).manual_seed(
            zlib.crc32(model_id.encode()) & 0x7FFFFFFF)
        lora = init_lora(self._cfg, self._lcfg, gen, self.device)
        # B starts at 0 in real LoRA (adapted == base); nudge it so
        # distinct adapters actually generate distinct tokens in demos
        for ab in lora["layers"].values():
            ab["b"] = torch.randn(ab["b"].shape, generator=gen,
                                  dtype=ab["b"].dtype,
                                  device=self.device) * 0.02
        with self._adapter_lock:
            self._adapters[model_id] = lora
            while len(self._adapters) > self._max_adapters:
                self._adapters.popitem(last=False)
        return lora

    # -------------------------------------------------------------- serving
    @staticmethod
    def _normalize(payload: Any) -> Dict[str, Any]:
        if isinstance(payload, dict):
            return payload
        return {"prompt": list(payload)}

    def _prefill(self, payload: Any, model_id: str) -> Dict[str, Any]:
        p = self._normalize(payload)
        prompt = [int(t) for t in p.get("prompt", [0])] or [0]
        vocab = self._cfg.vocab_size
        prompt = [t % vocab for t in prompt]
        return {
            "tokens": prompt,
            "prompt_len": len(prompt),
            "max_new": min(int(p.get("max_new", self.max_new_tokens)),
                           self.max_new_tokens),
        }

    def _step(self, model_id: str, states: List[Optional[Dict]]) -> List:
        """One decode iteration for one adapter group: pad the live rows
        to (bucket, seq_bucket-multiple), one forward, greedy next token
        per row (argmax on the device; the first index on ties, as
        ``np.argmax``)."""
        live = [(i, s) for i, s in enumerate(states) if s is not None]
        bucket = len(states)
        max_len = max(len(s["tokens"]) for _, s in live)
        pad_len = -(-max_len // self.seq_bucket) * self.seq_bucket
        pad_len = min(pad_len, self._cfg.max_seq_len)
        tokens = np.zeros((bucket, pad_len), np.int64)
        last = []
        for row, (_, s) in enumerate(live):
            ts = s["tokens"][-pad_len:]
            tokens[row, :len(ts)] = ts
            last.append(min(len(s["tokens"]), pad_len) - 1)
        with torch.inference_mode():
            logits = llama_forward(
                self._params, torch.from_numpy(tokens).to(self.device),
                self._cfg, lora=self._adapter(model_id),
                lora_cfg=self._lcfg)
            rows = torch.arange(len(live), device=self.device)
            cols = torch.tensor(last, device=self.device)
            nxt_all = logits[rows, cols].argmax(dim=-1).tolist()
        results: List[Optional[tuple]] = [None] * len(states)
        for (idx, s), nxt in zip(live, nxt_all):
            s["tokens"].append(nxt)
            done = len(s["tokens"]) - s["prompt_len"] >= s["max_new"]
            results[idx] = (nxt, done)
        return results

    def __call__(self, payload: Any):
        """Streaming endpoint: yields generated token ids one at a time."""
        p = self._normalize(payload)
        yield from self.engine.submit(p, str(p.get("adapter", "")))

    def engine_stats(self) -> Dict[str, int]:
        return self.engine.stats()
