"""ray_tpu_torch.util.collective on the port's runtime, on the CPU: the JAX
package's collective tests (``tests/test_collective.py``: allreduce,
barrier, broadcast, allgather, reducescatter, reduce, send/recv, the
declarative group) against numpy, CPU tensors through the host group, the
NCCL group's class built over gloo on CPU tensors (every op, and
``allreduce_sharded`` over a two-rank mesh), and the NCCL backend raising
without CUDA.

One port cluster per module. Actor classes are defined inside the fixtures
and tests, so that they travel by value and no worker imports this module
(and with it jax)."""

import os

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import ray_tpu_torch  # noqa: E402
from ray_tpu_torch.util import collective as col  # noqa: E402
from ray_tpu_torch.util.collective.types import Backend  # noqa: E402
from tests.test_torch_runtime import port_session_leak_check  # noqa: E402
from tests.test_torch_runtime import (  # noqa: E402,F401
    other_workers_jax_sessions_end)


@pytest.fixture(scope="module")
def port_cluster():
    ray_tpu_torch.init(num_cpus=4)
    session_dir = ray_tpu_torch._global_node.session_dir
    yield session_dir
    ray_tpu_torch.shutdown()
    port_session_leak_check(session_dir)


def _member_class():
    class Member:
        def __init__(self, rank, world_size, backend="cpu", group="g"):
            from ray_tpu_torch.util import collective as col

            self.col = col
            self.rank = rank
            self.ws = world_size
            self.group = group
            col.init_collective_group(world_size, rank, backend=backend,
                                      group_name=group)

        def do_allreduce(self):
            x = np.full((4,), float(self.rank + 1), np.float64)
            return self.col.allreduce(x, group_name=self.group)

        def do_barrier(self):
            self.col.barrier(group_name=self.group)
            return self.rank

        def do_broadcast(self):
            x = np.arange(3.0) if self.rank == 0 else np.zeros(3)
            return self.col.broadcast(x, src_rank=0, group_name=self.group)

        def do_allgather(self):
            return self.col.allgather(np.array([float(self.rank)]),
                                      group_name=self.group)

        def do_reducescatter(self):
            shards = [np.full((2,), float(self.rank * 10 + i))
                      for i in range(self.ws)]
            return self.col.reducescatter(shards, group_name=self.group)

        def do_reduce(self):
            x = np.full((2,), float(self.rank + 1))
            return self.col.reduce(x, dst_rank=0, group_name=self.group)

        def do_sendrecv(self):
            if self.rank == 0:
                self.col.send(np.array([42.0]), dst_rank=1,
                              group_name=self.group)
                return None
            return self.col.recv(None, src_rank=0, group_name=self.group)

        def do_tensor_allreduce(self):
            import torch

            x = torch.full((3,), float(self.rank + 1))
            out = self.col.allreduce(x, group_name=self.group)
            # a CPU tensor comes back as itself, updated in place
            return out is x, x.numpy()

        def rank_info(self):
            return (self.col.get_rank(self.group),
                    self.col.get_collective_group_size(self.group))

    return Member


@pytest.fixture(scope="module")
def members(port_cluster):
    Member = ray_tpu_torch.remote(_member_class())
    ms = [Member.remote(r, 2, "cpu", "g") for r in range(2)]
    assert ray_tpu_torch.get([m.rank_info.remote() for m in ms],
                             timeout=60) == [(0, 2), (1, 2)]
    yield ms


def test_allreduce(members):
    for o in ray_tpu_torch.get([m.do_allreduce.remote() for m in members]):
        np.testing.assert_allclose(o, np.full((4,), 3.0))


def test_barrier(members):
    assert sorted(ray_tpu_torch.get(
        [m.do_barrier.remote() for m in members])) == [0, 1]


def test_broadcast(members):
    for o in ray_tpu_torch.get([m.do_broadcast.remote() for m in members]):
        np.testing.assert_allclose(o, np.arange(3.0))


def test_allgather(members):
    for o in ray_tpu_torch.get([m.do_allgather.remote() for m in members]):
        np.testing.assert_allclose(np.concatenate(o), [0.0, 1.0])


def test_reducescatter(members):
    out = ray_tpu_torch.get([m.do_reducescatter.remote() for m in members])
    # rank r gets the sum over members of shard r: (0*10+r) + (1*10+r)
    np.testing.assert_allclose(out[0], np.full((2,), 10.0))
    np.testing.assert_allclose(out[1], np.full((2,), 12.0))


def test_reduce(members):
    out = ray_tpu_torch.get([m.do_reduce.remote() for m in members])
    np.testing.assert_allclose(out[0], np.full((2,), 3.0))  # root reduced
    np.testing.assert_allclose(out[1], np.full((2,), 2.0))  # non-root as is


def test_send_recv(members):
    out = ray_tpu_torch.get([m.do_sendrecv.remote() for m in members])
    assert out[0] is None
    np.testing.assert_allclose(out[1], [42.0])


def test_cpu_tensors_through_host_group(members):
    out = ray_tpu_torch.get(
        [m.do_tensor_allreduce.remote() for m in members])
    for same, x in out:
        assert same
        np.testing.assert_allclose(x, np.full((3,), 3.0))


def test_declarative_group(port_cluster):
    class Plain:
        def ar(self):
            from ray_tpu_torch.util import collective as col

            return col.allreduce(np.ones(2), group_name="decl_g")

    actors = [ray_tpu_torch.remote(Plain).remote() for _ in range(2)]
    col.create_collective_group(actors, 2, [0, 1], backend="cpu",
                                group_name="decl_g")
    for o in ray_tpu_torch.get([a.ar.remote() for a in actors], timeout=60):
        np.testing.assert_allclose(o, np.full((2,), 2.0))


def test_nccl_group_class_over_gloo(port_cluster):
    """NCCLGroup's ops, built with gloo on CPU tensors (what the class runs
    on CUDA tensors over NCCL), against numpy; each op works in place on
    its tensor. ``allreduce_sharded`` sums over a two-rank mesh of each
    member's own gloo world, then across the group."""
    class GlooMember:
        def __init__(self, rank):
            from ray_tpu_torch.util.collective.collective_group.nccl_group \
                import NCCLGroup

            self.rank = rank
            self.g = NCCLGroup(2, rank, "ng", backend="gloo")

        def run(self, mesh_port):
            import torch
            import torch.distributed as dist

            from ray_tpu_torch.parallel.mesh import MeshConfig, create_mesh
            from ray_tpu_torch.util.collective.types import (
                AllReduceOptions, BroadcastOptions, RecvOptions, ReduceOp,
                ReduceOptions, SendOptions)

            r, g, out = self.rank, self.g, {}
            x = torch.full((4,), float(r + 1))
            out["same"] = g.allreduce(x) is x
            out["allreduce"] = x.numpy().copy()
            m = torch.full((2,), float(r + 1))
            g.allreduce(m, AllReduceOptions(reduceOp=ReduceOp.MAX))
            out["max"] = m.numpy().copy()
            g.barrier()
            b = torch.arange(3.0) if r == 0 else torch.zeros(3)
            out["broadcast"] = g.broadcast(b, BroadcastOptions()).numpy()
            out["allgather"] = [t.numpy() for t in
                                g.allgather(torch.tensor([float(r)]))]
            shards = [torch.full((2,), float(r * 10 + i)) for i in range(2)]
            out["reducescatter"] = g.reducescatter(shards).numpy()
            red = torch.full((2,), float(r + 1))
            out["reduce"] = g.reduce(red, ReduceOptions(root_rank=0)).numpy()
            if r == 0:
                g.send(torch.tensor([42.0]), SendOptions(dst_rank=1))
            else:
                out["recv"] = g.recv(torch.zeros(1),
                                     RecvOptions(src_rank=0)).numpy()
            # a default gloo world of the two members and a mesh over it
            dist.init_process_group(
                "gloo", init_method=f"tcp://localhost:{mesh_port}",
                world_size=2, rank=r)
            mesh = create_mesh(MeshConfig(data=-1), device="cpu")
            full = torch.arange(4.0)  # the same on both ranks
            out["sharded"] = g.allreduce_sharded(full, mesh, "data").numpy()
            out["unit_axis"] = g.local_psum(full, mesh, "tensor").numpy()
            dist.destroy_process_group()
            g.destroy_group()
            return out

    from ray_tpu_torch.train._internal.util import find_free_port

    Member = ray_tpu_torch.remote(GlooMember)
    ms = [Member.remote(r) for r in range(2)]
    port = find_free_port()
    out = ray_tpu_torch.get([m.run.remote(port) for m in ms], timeout=120)
    for r, o in enumerate(out):
        assert o["same"]
        np.testing.assert_allclose(o["allreduce"], np.full((4,), 3.0))
        np.testing.assert_allclose(o["max"], np.full((2,), 2.0))
        np.testing.assert_allclose(o["broadcast"], np.arange(3.0))
        np.testing.assert_allclose(np.concatenate(o["allgather"]),
                                   [0.0, 1.0])
        np.testing.assert_allclose(o["reducescatter"],
                                   np.full((2,), 10.0 + 2 * r))
        # the mesh sums the halves x[:2] + x[2:], then the group sums its
        # two members: 2 * ([0, 1] + [2, 3])
        np.testing.assert_allclose(o["sharded"], [4.0, 8.0])
        np.testing.assert_allclose(o["unit_axis"], np.arange(4.0))
    np.testing.assert_allclose(out[0]["reduce"], np.full((2,), 3.0))
    np.testing.assert_allclose(out[1]["reduce"], np.full((2,), 2.0))
    np.testing.assert_allclose(out[1]["recv"], [42.0])


@pytest.mark.parametrize("name", ["nccl", "gpu", "xla", Backend.NCCL])
def test_nccl_backend_raises_without_cuda(name):
    """Without CUDA the device backend raises at init; it never falls back
    to gloo or to the host store."""
    assert not torch.cuda.is_available()
    assert Backend.coerce(name) is Backend.NCCL
    with pytest.raises(RuntimeError, match="needs CUDA"):
        col.init_collective_group(1, 0, backend=name,
                                  group_name=f"no_cuda_{name}")
    assert not col.is_group_initialized(f"no_cuda_{name}")


@pytest.mark.parametrize("name", ["cpu", "gloo", "host"])
def test_host_backend_names(name):
    assert Backend.coerce(name) is Backend.CPU
