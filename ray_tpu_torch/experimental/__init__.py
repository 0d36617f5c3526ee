"""Experimental utilities (reference: python/ray/experimental/ —
internal_kv :121, tqdm_ray, channel; copied from ``ray_tpu/experimental``):
``internal_kv``, ``Channel``, the shared-memory channel the compiled DAG
(``ray_tpu_torch.dag``) runs over, and, imported by name as in the
reference, ``tqdm_ray`` (progress bars proxied to the driver) and
``dynamic_resources`` (``set_resource``)."""

from ray_tpu_torch.experimental import internal_kv
from ray_tpu_torch.experimental.channel import Channel

__all__ = ["internal_kv", "Channel"]
