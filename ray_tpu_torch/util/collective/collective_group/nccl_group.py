"""NCCL collective group: the device backend of ``ray_tpu_torch.util.collective``.

Port of ``ray_tpu/util/collective/collective_group/xla_group.py`` (the JAX
package's device-mesh group; reference:
python/ray/util/collective/collective_group/nccl_collective_group.py:127).

A group is a ``torch.distributed`` process group of its own (not the
process's default group), one member per actor: rank 0 starts a ``TCPStore``
on a free port of its node, and that address rides the named store actor
(the counterpart of the reference's NCCL uniqueId broadcast); every member
then joins ``ProcessGroupNCCL`` over it. Ops take CUDA tensors and run in
place on torch's current stream (the NCCL stream is joined to it), and the
tensor is returned. Without CUDA the group raises: it never falls back to
gloo. A host run builds the same class with ``backend="gloo"``, said
explicitly, over CPU tensors.

:meth:`NCCLGroup.local_psum` is the JAX group's psum over one axis of the
member's local mesh: an all-reduce over that dim of a ``DeviceMesh``.
"""

from __future__ import annotations

import datetime
from typing import Any, List

import torch
import torch.distributed as dist

from ray_tpu_torch.util.collective.collective_group.cpu_group import CPUGroup
from ray_tpu_torch.util.collective.types import (
    AllGatherOptions, AllReduceOptions, BarrierOptions, BroadcastOptions,
    RecvOptions, ReduceOp, ReduceOptions, ReduceScatterOptions, SendOptions)

# bound on the rendezvous (the address exchange, the TCPStore) and on a
# gloo op
_TIMEOUT_S = 300

_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.PRODUCT:
        dist.ReduceOp.PRODUCT, ReduceOp.MIN: dist.ReduceOp.MIN,
        ReduceOp.MAX: dist.ReduceOp.MAX}


def _node_address() -> str:
    """This node's address as the runtime knows it (``localhost`` when no
    runtime is connected: one host)."""
    from ray_tpu_torch._private.worker import global_worker, node_ip

    if global_worker is None or not global_worker.connected:
        return "localhost"
    return node_ip()


class NCCLGroup(CPUGroup):
    """Members rendezvous through the named store actor (as
    :class:`CPUGroup` does) and exchange tensors over their own
    ``torch.distributed`` process group."""

    def __init__(self, world_size: int, rank: int, group_name: str,
                 store_key: str = "", backend: str = "nccl"):
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"backend {backend!r}: expected 'nccl', or "
                             "'gloo' for a host run")
        if backend == "nccl" and not torch.cuda.is_available():
            raise RuntimeError(
                "the NCCL collective group needs CUDA, which is not "
                "available; ask for backend='cpu' (the host store group) or "
                "build NCCLGroup(..., backend='gloo') for CPU tensors")
        super().__init__(world_size, rank, group_name, store_key)
        from ray_tpu_torch.train._internal.util import find_free_port

        self._pg_backend = backend
        self._device = (torch.device("cuda", torch.cuda.current_device())
                        if backend == "nccl" else torch.device("cpu"))
        timeout = datetime.timedelta(seconds=_TIMEOUT_S)
        tcp = None
        payload = None
        if rank == 0:
            port = find_free_port()
            tcp = dist.TCPStore("0.0.0.0", port, world_size, True, timeout,
                                wait_for_workers=False)
            payload = (_node_address(), port)
        addr, port = self._exchange("rdv", payload, _TIMEOUT_S * 1000)[0]
        if tcp is None:
            tcp = dist.TCPStore(addr, port, world_size, False, timeout)
        self._tcp = tcp
        store = dist.PrefixStore(f"{store_key or group_name}/", tcp)
        if backend == "nccl":
            self._pg = dist.ProcessGroupNCCL(store, rank, world_size)
        else:
            self._pg = dist.ProcessGroupGloo(store, rank, world_size, timeout)

    @classmethod
    def backend(cls) -> str:
        return "nccl"

    def destroy_group(self) -> None:
        shutdown = getattr(self._pg, "shutdown", None)
        if shutdown is not None:
            shutdown()
        self._pg = None
        super().destroy_group()

    def _check(self, tensor) -> torch.Tensor:
        if not isinstance(tensor, torch.Tensor):
            raise TypeError(f"the {self._pg_backend} group takes torch "
                            f"tensors, got {type(tensor).__name__}")
        if tensor.device.type != self._device.type:
            raise ValueError(f"tensor on {tensor.device}; the "
                             f"{self._pg_backend} group's tensors are on "
                             f"{self._device.type}")
        return tensor

    # -- ops: in place, on the current stream ------------------------------

    def allreduce(self, tensor, opts: AllReduceOptions = AllReduceOptions()):
        o = dist.AllreduceOptions()
        o.reduceOp = _OPS[opts.reduceOp]
        self._pg.allreduce([self._check(tensor)], o).wait()
        return tensor

    def barrier(self, opts: BarrierOptions = BarrierOptions()):
        flag = torch.zeros(1, device=self._device)
        self._pg.allreduce([flag]).wait()
        if self._device.type == "cuda":
            torch.cuda.current_stream(self._device).synchronize()

    def reduce(self, tensor, opts: ReduceOptions = ReduceOptions()):
        o = dist.ReduceOptions()
        o.reduceOp = _OPS[opts.reduceOp]
        o.rootRank = opts.root_rank
        self._pg.reduce([self._check(tensor)], o).wait()
        return tensor

    def allgather(self, tensor,
                  opts: AllGatherOptions = AllGatherOptions()) -> List[Any]:
        out = [torch.empty_like(self._check(tensor))
               for _ in range(self._world_size)]
        self._pg.allgather([out], [tensor]).wait()
        return out

    def broadcast(self, tensor, opts: BroadcastOptions = BroadcastOptions()):
        o = dist.BroadcastOptions()
        o.rootRank = opts.root_rank
        self._pg.broadcast([self._check(tensor)], o).wait()
        return tensor

    def reducescatter(self, tensor_list,
                      opts: ReduceScatterOptions = ReduceScatterOptions()):
        """Each member contributes world_size shards; its own shard
        (``tensor_list[rank]``) becomes the reduced one, returned."""
        if len(tensor_list) != self._world_size:
            raise ValueError(
                f"reducescatter needs {self._world_size} input shards, got "
                f"{len(tensor_list)}")
        mine = tensor_list[self._rank]
        out = torch.empty_like(self._check(mine))
        o = dist.ReduceScatterOptions()
        o.reduceOp = _OPS[opts.reduceOp]
        self._pg.reduce_scatter([out], [list(tensor_list)], o).wait()
        mine.copy_(out)
        return mine

    def send(self, tensor, opts: SendOptions):
        self._pg.send([self._check(tensor).contiguous()], opts.dst_rank,
                      0).wait()

    def recv(self, like, opts: RecvOptions):
        """Receive into ``like`` (its shape and type), in place."""
        if like is None:
            raise ValueError("the NCCL group receives into a tensor of the "
                             "sent shape and type: pass it as ``like``")
        self._pg.recv([self._check(like)], opts.src_rank, 0).wait()
        return like

    # -- mesh-native helpers -----------------------------------------------

    @staticmethod
    def local_psum(tensor, mesh, axis: str) -> torch.Tensor:
        """Sum over one axis of the member's ``DeviceMesh``: ``tensor``'s
        dim 0 is split over ``axis`` (a DTensor, or the full tensor, the
        same on every rank of the mesh), and every rank gets the sum of the
        blocks (the JAX group's ``psum`` under ``shard_map``). An axis that
        is not a dim of the mesh has size 1: the sum is the tensor."""
        from torch.distributed.tensor import (
            DTensor, Replicate, Shard, distribute_tensor)

        names = mesh.mesh_dim_names or ()
        if axis not in names:
            return (tensor.full_tensor() if isinstance(tensor, DTensor)
                    else tensor).clone()
        if not isinstance(tensor, DTensor):
            placements = [Replicate()] * mesh.ndim
            placements[names.index(axis)] = Shard(0)
            tensor = distribute_tensor(tensor, mesh, placements,
                                       src_data_rank=None)
        local = tensor.to_local().clone()
        dist.all_reduce(local, group=mesh.get_group(axis))
        return local

    def allreduce_sharded(self, tensor, mesh, axis: str,
                          op: ReduceOp = ReduceOp.SUM):
        """Hierarchical allreduce: the sum over the member's mesh axis, then
        the combine across the group's members (reference analog:
        nccl_collective_group allreduce_multigpu)."""
        local = self.local_psum(tensor, mesh, axis)
        return self.allreduce(local, AllReduceOptions(reduceOp=op))
