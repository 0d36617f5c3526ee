"""ray_tpu_torch.util — utilities (reference: python/ray/util/; copied from
``ray_tpu/util``): ActorPool (``actor_pool.py``), Queue (``queue.py``),
metrics, the state API (``state``), chaos killers (``chaos.py``),
``check_serialize``, scheduling strategies and placement groups,
``ray_tpu_torch.util.collective``, the collective API across actors (host
and NCCL backends), accelerator constants and pod-slice helpers
(``accelerators``), OpenTelemetry-optional spans mirrored to ``timeline()``
(``tracing``), a ``multiprocessing.Pool`` over actors
(``multiprocessing``), the joblib backend (``joblib``, gated on joblib),
parallel iterators (``iter``), the dask scheduler (``dask``, gated on
dask), a remote pdb (``rpdb``) and the ``ray://`` client (``client``)."""

from ray_tpu_torch.util.actor_pool import ActorPool
from ray_tpu_torch.util.queue import Queue

__all__ = ["ActorPool", "Queue"]
