"""ray_tpu_torch.parallel's mesh and sharding rules against the JAX
package's, on the CPU: ``MeshConfig.resolve`` and ``best_mesh_shape``;
``logical_to_spec``; the placement of every leaf of ``llama_logical_axes``,
``lora_logical_axes`` and ``mlp_logical_axes`` (each rank's slice of each
leaf against the slice JAX gives the device at the same mesh position, on the
conftest's 8 virtual CPU devices); and the optimizer state's placements for
``adamw`` and ``adafactor`` against ``_opt_state_shardings``.

The port's meshes here are built over torch's in-process "fake" process
group of 8 ranks (``torch.testing``'s ``FakeStore``): it gives a real
``DeviceMesh`` and DTensors whose collectives move nothing, which is all a
placement needs. The module sets it up and tears it down."""

import dataclasses
import os

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate  # noqa: E402
from torch.distributed.tensor._utils import (  # noqa: E402
    _compute_local_shape_and_global_offset)

from ray_tpu.models import llama as jl  # noqa: E402
from ray_tpu.models import mlp as jm  # noqa: E402
from ray_tpu.parallel import mesh as jmesh  # noqa: E402
from ray_tpu.parallel import sharding as jsh  # noqa: E402
from ray_tpu.parallel import train_step as jts  # noqa: E402
from ray_tpu_torch._private.tree import tree_leaves  # noqa: E402
from ray_tpu_torch.models import llama as tl  # noqa: E402
from ray_tpu_torch.models import mlp as tm  # noqa: E402
from ray_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from ray_tpu_torch.parallel import optim as topt  # noqa: E402
from ray_tpu_torch.parallel import sharding as tsh  # noqa: E402
from ray_tpu_torch.parallel import train_step as tts  # noqa: E402
from tests.test_torch_runtime import (  # noqa: E402,F401
    other_workers_jax_sessions_end)

WORLD = 8
MESHES = [dict(data=-1, fsdp=2, tensor=2), dict(data=-1, fsdp=4),
          dict(data=-1, fsdp=2, seq=2, tensor=2), dict(data=-1),
          dict(data=2, expert=4), dict(data=-1, stage=2, fsdp=2, tensor=2)]


@pytest.fixture(scope="module")
def fake_world():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=WORLD)
    yield
    dist.destroy_process_group()


def _norm(spec):
    """A spec's entries with 1-tuples as their one name."""
    out = []
    for e in tuple(spec):
        if isinstance(e, tuple) and len(e) == 1:
            e = e[0]
        out.append(tuple(e) if isinstance(e, (tuple, list)) else e)
    return tuple(out)


# --------------------------------------------------------------- mesh shape

@pytest.mark.parametrize("cfg,n", [
    (dict(data=-1, fsdp=2), 8), (dict(data=-1, fsdp=2, tensor=2), 8),
    (dict(data=-1), 1), (dict(data=-1, seq=2, tensor=2), 8),
    (dict(data=3, fsdp=2), 8), (dict(data=-1, fsdp=-1), 8),
    (dict(data=-1, fsdp=3), 8), (dict(data=2, fsdp=2), 4)])
def test_mesh_config_resolve_matches_jax(cfg, n):
    def run(mod):
        try:
            return mod.MeshConfig(**cfg).resolve(n)
        except ValueError as e:
            return type(e)
    assert run(tmesh) == run(jmesh)
    assert tmesh.AXIS_ORDER == jmesh.AXIS_ORDER
    assert tmesh.MeshConfig().axis_names == jmesh.MeshConfig().axis_names


@pytest.mark.parametrize("n,kw", [
    (8, {}), (8, dict(tensor=2)), (8, dict(tensor=2, seq=2)),
    (8, dict(fsdp=2)), (1, {}), (4, dict(seq=4))])
def test_best_mesh_shape_matches_jax(n, kw):
    assert dataclasses.asdict(tmesh.best_mesh_shape(n, **kw)) == \
        dataclasses.asdict(jmesh.best_mesh_shape(n, **kw))


def test_mesh_dims_and_axis_sizes(fake_world):
    mesh = tmesh.create_mesh(tmesh.MeshConfig(data=-1, fsdp=2, tensor=2),
                             device="cpu")
    assert mesh.mesh_dim_names == ("data", "fsdp", "tensor")
    assert tuple(mesh.shape) == (2, 2, 2)
    assert tmesh.mesh_axes(tmesh.MeshConfig(data=-1, fsdp=2, tensor=2)
                           .resolve(WORLD)) == ("data", "fsdp", "tensor")
    one = tmesh.create_mesh(tmesh.MeshConfig(data=8), device="cpu")
    assert one.mesh_dim_names == ("data",)
    assert tmesh.mesh_axes(tmesh.MeshConfig().resolve(1)) == ("data",)


def test_create_mesh_needs_cuda_or_the_cpu_asked_for(fake_world):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.create_mesh(tmesh.MeshConfig())


# ------------------------------------------------------------------ specs

@pytest.mark.parametrize("axes", [
    ("embed", "mlp"), ("mlp", "mlp"), ("batch", "seq"),
    ("batch", "seq", "embed"), ("batch", "seq", "heads", None),
    ("vocab", "embed"), ("embed", "vocab"), (None, "embed", "heads",
                                             "head_dim"),
    ("batch", "embed"), ("norm",), ("expert", "embed", "mlp"), ()])
def test_logical_to_spec_matches_jax(axes):
    assert _norm(tsh.logical_to_spec(axes)) == \
        _norm(jsh.logical_to_spec(axes))
    rules = {"batch": ("data", "fsdp"), "embed": ("fsdp", "tensor"),
             "mlp": "tensor"}
    assert _norm(tsh.logical_to_spec(axes, rules)) == \
        _norm(jsh.logical_to_spec(axes, rules))


def _trees():
    """(name, logical-axes tree, shapes tree) of each family, tiny llama
    (and its LoRA) and the MLP, from the JAX package's own shapes."""
    cfg = jl.LlamaConfig.tiny()
    lcfg = jl.LoraConfig(rank=4)
    key = jax.random.key(0)
    llama = jax.eval_shape(lambda: jl.init_llama(cfg, key))
    lora = jax.eval_shape(lambda: jl.init_lora(cfg, lcfg, key))
    mlp = jax.eval_shape(lambda: jm.init_mlp(jm.MLPConfig(), key))
    tcfg, tlcfg = tl.LlamaConfig.tiny(), tl.LoraConfig(rank=4)
    return [
        ("llama", jl.llama_logical_axes(cfg), tl.llama_logical_axes(tcfg),
         llama),
        ("lora", jl.lora_logical_axes(cfg, lcfg),
         tl.lora_logical_axes(tcfg, tlcfg), lora),
        ("mlp", jm.mlp_logical_axes(jm.MLPConfig()),
         tm.mlp_logical_axes(tm.MLPConfig()), mlp)]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flat(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


@pytest.mark.parametrize("mesh_kw", MESHES)
def test_leaf_placements_match_jax_shardings(fake_world, mesh_kw):
    """Each rank's slice of each leaf, from the port's placements on its
    ``DeviceMesh``, equals the slice JAX's ``NamedSharding`` gives the
    device at the same position of its mesh (row-major over the six axes;
    the port's mesh leaves the axes of size 1 out, which keeps the order)."""
    jmesh_ = jmesh.create_mesh(jmesh.MeshConfig(**mesh_kw),
                               devices=jax.devices()[:WORLD])
    tmesh_ = tmesh.create_mesh(tmesh.MeshConfig(**mesh_kw), device="cpu")
    devices = list(jmesh_.devices.flat)
    coords = list(np.ndindex(*tuple(tmesh_.shape)))
    assert len(devices) == len(coords) == WORLD
    for name, jaxes, taxes, shapes in _trees():
        assert _flat(jaxes) == _flat(taxes), name
        jsh_tree = jsh.param_shardings(jaxes, jmesh_)
        tsh_tree = tsh.param_shardings(taxes, tmesh_)
        for (path, js), (_, ts), (_, shp) in zip(
                _flat(jsh_tree), _flat(tsh_tree), _flat(shapes)):
            assert _norm(ts.spec) == _norm(js.spec), (name, path)
            shape = tuple(shp.shape)
            jidx = js.devices_indices_map(shape)
            for dev, coord in zip(devices, coords):
                lshape, offset = _compute_local_shape_and_global_offset(
                    shape, tuple(tmesh_.shape), list(coord), ts.placements)
                want = tuple(
                    (s.start or 0, s.stop if s.stop is not None else n)
                    for s, n in zip(jidx[dev], shape))
                got = tuple((o, o + n) for o, n in zip(offset, lshape))
                assert got == want, (name, path, mesh_kw, coord)


def test_spec_out_of_mesh_order_raises(fake_world):
    mesh = tmesh.create_mesh(tmesh.MeshConfig(data=-1, fsdp=2, tensor=2),
                             device="cpu")
    with pytest.raises(ValueError, match="axis order"):
        tsh.spec_to_placements(tsh.PartitionSpec(("tensor", "fsdp")), mesh)


def test_constrain_is_a_no_op_without_a_mesh():
    x = torch.ones(2, 3)
    assert tsh.constrain(x, ("batch", "embed")) is x
    assert tsh.ambient_mesh() is None


# ----------------------------------------------------------- optimizer state

_TORCH_NAMES = {"adamw": {"exp_avg": "mu", "exp_avg_sq": "nu"},
                "adafactor": {"v_row": "v_row", "v_col": "v_col",
                              "v": "v"}}


def _jax_state_specs(opt, mesh, params, axes):
    """{(state name, param path): spec} from ``_opt_state_shardings``."""
    tx = {"adamw": optax.adamw(1e-3), "adafactor": optax.adafactor(1e-3)}[opt]
    p_sh = jsh.param_shardings(axes, mesh)
    shardings = jts._opt_state_shardings(tx, params, p_sh, mesh)
    shapes = jax.eval_shape(tx.init, params)
    out = {}
    flat_sh = jax.tree_util.tree_flatten_with_path(shardings)[0]
    flat_shape = jax.tree.leaves(shapes)
    for (path, sh), shp in zip(flat_sh, flat_shape):
        names = [getattr(k, "name", None) for k in path]
        keys = [k.key for k in path if hasattr(k, "key")]
        state = next((n for n in reversed(names) if n), None)
        out[(state, "/" + "/".join(keys))] = (sh.spec, tuple(shp.shape))
    return out


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("mesh_kw", [dict(data=-1, fsdp=2, tensor=2),
                                     dict(data=-1, fsdp=8)])
def test_opt_state_placements_match_jax(fake_world, opt, mesh_kw):
    """After one update, each state tensor of each leaf is placed as
    ``_opt_state_shardings`` places its counterpart: shaped like the param →
    the param's placements; of lower rank → replicated. AdamW's step count
    is a 0-dim tensor, the same on every rank (JAX: replicated)."""
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(), dtype=torch.float32)
    jmesh_ = jmesh.create_mesh(jmesh.MeshConfig(**mesh_kw),
                               devices=jax.devices()[:WORLD])
    params = jax.eval_shape(lambda: jl.init_llama(jcfg, jax.random.key(0)))
    want = _jax_state_specs(opt, jmesh_, params, jl.llama_logical_axes(jcfg))

    mesh = tmesh.create_mesh(tmesh.MeshConfig(**mesh_kw), device="cpu")
    tx = getattr(topt, opt)(1e-3)
    state = tts.create_train_state(
        lambda g: tl.init_llama(tcfg, g, g.device), tx, mesh,
        tl.llama_logical_axes(tcfg), device="cpu")
    leaves = tree_leaves(state.params)
    for p in leaves:
        p.grad = torch.zeros_like(p)
    state.opt_state.step()
    paths = [path for path, _ in _flat(tl.llama_logical_axes(tcfg))]
    seen = 0
    for path, p in zip(paths, leaves):
        st = state.opt_state.state[p]
        for tname, jname in _TORCH_NAMES[opt].items():
            if tname not in st:
                continue
            v = st[tname]
            spec, jshape = want[(jname, path)]
            assert isinstance(v, DTensor), (path, tname)
            if tuple(v.shape) == tuple(p.shape):
                assert tuple(v.placements) == tuple(p.placements)
            else:  # lower rank: replicated on both
                assert all(isinstance(pl, Replicate)
                           for pl in v.placements), (path, tname)
                assert all(e is None for e in tuple(spec)), (path, jname)
            assert tuple(v.placements) == tsh.spec_to_placements(
                spec, mesh), (path, tname, spec)
            seen += 1
        if "step" in st and isinstance(st["step"], torch.Tensor):
            assert not isinstance(st["step"], DTensor)
            assert st["step"].dim() == 0
    assert seen >= len(leaves)
