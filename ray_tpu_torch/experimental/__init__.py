"""Experimental utilities (reference: python/ray/experimental/ —
internal_kv :121, channel; copied from ``ray_tpu/experimental``):
``internal_kv`` and ``Channel``, the shared-memory channel the compiled
DAG (``ray_tpu_torch.dag``) runs over."""

from ray_tpu_torch.experimental import internal_kv
from ray_tpu_torch.experimental.channel import Channel

__all__ = ["internal_kv", "Channel"]
