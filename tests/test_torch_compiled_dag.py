"""The port's DAG API (``ray_tpu_torch.dag``) on its runtime, on the CPU:
the cases of the JAX package's ``tests/test_compiled_dag.py`` to the same
expectations, the DOT text of ``visualize`` held equal to the JAX
package's for the same graph, and a compiled graph of two stages of a
small Llama whose logits equal the port's ``llama_forward`` bit for bit
and the JAX package's within ``tests/test_torch_llama.py``'s tolerance.

One port cluster for the module, started with one GPU declared
(``num_gpus=1``) so that a ``{"GPU": 0.5}`` stage gets a device id. Remote
functions and actors are made inside functions, so that they travel by
value and no worker imports this module (and with it jax)."""

import os
import time
import types

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import ray_tpu  # noqa: E402
import ray_tpu_torch  # noqa: E402
from ray_tpu.models import llama as jl  # noqa: E402
from ray_tpu_torch.dag import CompiledDAG, InputNode, MultiOutputNode  # noqa: E402
from ray_tpu_torch.models import llama as tl  # noqa: E402
from tests.test_torch_runtime import port_session_leak_check  # noqa: E402
from tests.test_torch_runtime import (  # noqa: E402,F401
    other_workers_jax_sessions_end)


@pytest.fixture(scope="module")
def ray4():
    ray_tpu_torch.init(num_cpus=4, num_gpus=1)
    session_dir = ray_tpu_torch._global_node.session_dir
    yield session_dir
    ray_tpu_torch.shutdown()
    port_session_leak_check(session_dir)


def _plain_fns():
    def plus_one(x):
        return x + 1

    def times_two(x):
        return x * 2

    def add(a, b):
        return a + b

    return plus_one, times_two, add


@pytest.fixture(scope="module")
def fns():
    """``plus_one``, ``times_two`` and ``add`` as the port's remote
    functions."""
    return types.SimpleNamespace(**{
        f.__name__: ray_tpu_torch.remote(f) for f in _plain_fns()})


class TestCompiledCorrectness:
    def test_three_stage_pipeline_repeat(self, ray4, fns):
        with InputNode() as inp:
            dag = fns.plus_one.bind(fns.times_two.bind(fns.plus_one.bind(inp)))
        compiled = dag.experimental_compile()
        try:
            for i in range(20):
                ref = compiled.execute(i)
                assert ref.get(timeout=60) == (i + 1) * 2 + 1
        finally:
            compiled.teardown()

    def test_diamond_and_constants(self, ray4, fns):
        with InputNode() as inp:
            a = fns.plus_one.bind(inp)
            b = fns.times_two.bind(inp)
            dag = fns.add.bind(a, b)
        compiled = dag.experimental_compile()
        try:
            assert ray_tpu_torch.get(compiled.execute(10)) == 31
            assert ray_tpu_torch.get(compiled.execute(0)) == 1
        finally:
            compiled.teardown()

    def test_kwargs_and_const_args(self, ray4):
        @ray_tpu_torch.remote
        def scale(x, factor=1):
            return x * factor

        with InputNode() as inp:
            dag = scale.bind(inp, factor=3)
        compiled = dag.experimental_compile()
        try:
            assert compiled.execute(5).get(timeout=60) == 15
        finally:
            compiled.teardown()

    def test_multi_output(self, ray4, fns):
        with InputNode() as inp:
            dag = MultiOutputNode([fns.plus_one.bind(inp),
                                   fns.times_two.bind(inp)])
        compiled = dag.experimental_compile()
        try:
            assert ray_tpu_torch.get(compiled.execute(3)) == [4, 6]
            assert ray_tpu_torch.get(compiled.execute(10)) == [11, 20]
        finally:
            compiled.teardown()

    def test_pipelined_inflight_out_of_order_get(self, ray4, fns):
        with InputNode() as inp:
            dag = fns.plus_one.bind(inp)
        compiled = dag.experimental_compile()
        try:
            refs = [compiled.execute(i) for i in range(5)]
            # consume out of order: later ref first
            assert refs[3].get(timeout=60) == 4
            assert refs[0].get(timeout=60) == 1
            assert [r.get(timeout=60) for r in refs[1:3]] == [2, 3]
            assert refs[4].get(timeout=60) == 5
            with pytest.raises(ValueError, match="already consumed"):
                refs[0].get()
        finally:
            compiled.teardown()

    def test_input_attribute_projections(self, ray4, fns):
        """inp[key] projections in eager and compiled execution: each
        branch receives only its projection."""
        with InputNode() as inp:
            a = fns.plus_one.bind(inp["x"])
            b = fns.times_two.bind(inp["y"])
            dag = fns.add.bind(a, b)
        assert ray_tpu_torch.get(dag.execute({"x": 3, "y": 5})) == 14
        compiled = dag.experimental_compile()
        try:
            assert compiled.execute({"x": 3, "y": 5}).get(timeout=60) == 14
            assert compiled.execute({"x": 0, "y": 1}).get(timeout=60) == 3
            # a bad input fails before any channel write (no desync)
            with pytest.raises(KeyError):
                compiled.execute({"x": 1})
            assert compiled.execute({"x": 2, "y": 2}).get(timeout=60) == 7
        finally:
            compiled.teardown()

    def test_visualize_dot(self, ray4, fns):
        @ray_tpu_torch.remote
        class V:
            def go(self, x):
                return x

        v = V.remote()
        with InputNode() as inp:
            dag = v.go.bind(fns.add.bind(fns.plus_one.bind(inp["a"]),
                                         fns.times_two.bind(inp["b"])))
        dot = dag.visualize()
        assert dot.startswith("digraph dag {") and dot.endswith("}")
        for want in ("plus_one", "times_two", "add", "V.go",
                     "INPUT['a']", "INPUT['b']", "->"):
            assert want in dot, dot
        ray_tpu_torch.kill(v)

    def test_async_execution(self, ray4, fns):
        """execute_async + awaitable refs."""
        import asyncio

        with InputNode() as inp:
            dag = fns.plus_one.bind(fns.times_two.bind(inp))
        compiled = dag.experimental_compile()

        async def drive():
            refs = [await compiled.execute_async(i) for i in range(4)]
            # concurrent awaits (gather spawns threads): result
            # bookkeeping must serialize, not corrupt or deadlock
            out = await asyncio.gather(*[r.get_async() for r in refs])
            one = await compiled.execute_async(10)
            out.append(await one)  # plain awaitable ref
            return out

        try:
            assert asyncio.run(drive()) == [1, 3, 5, 7, 21]
        finally:
            compiled.teardown()

    def test_async_cancellation_releases_consumer_lock(self, ray4):
        """asyncio.wait_for cancelling a get_async must not leave a
        thread camped on the consumer lock: a later get still works and
        receives the (slow) result."""
        import asyncio

        @ray_tpu_torch.remote
        def slow(x):
            import time

            time.sleep(3.0)
            return x + 1

        with InputNode() as inp:
            dag = slow.bind(inp)
        compiled = dag.experimental_compile()
        try:
            ref = compiled.execute(41)

            async def impatient():
                with pytest.raises(asyncio.TimeoutError):
                    await asyncio.wait_for(ref.get_async(), 0.3)

            asyncio.run(impatient())
            # the cancelled chunk (<= 2 s) expires before the 3 s result
            # lands, so the value is preserved for the real consumer
            assert ref.get(timeout=60) == 42
        finally:
            compiled.teardown()

    def test_numpy_payload(self, ray4):
        @ray_tpu_torch.remote
        def double(x):
            return x * 2

        with InputNode() as inp:
            dag = double.bind(double.bind(inp))
        compiled = dag.experimental_compile()
        try:
            arr = np.arange(1024, dtype=np.float32)
            out = compiled.execute(arr).get(timeout=60)
            np.testing.assert_allclose(out, arr * 4)
        finally:
            compiled.teardown()


class TestCompiledActors:
    def test_actor_state_persists(self, ray4):
        @ray_tpu_torch.remote
        class Accum:
            def __init__(self):
                self.total = 0

            def add(self, v):
                self.total += v
                return self.total

        acc = Accum.remote()
        with InputNode() as inp:
            dag = acc.add.bind(inp)
        compiled = dag.experimental_compile()
        try:
            assert compiled.execute(5).get(timeout=60) == 5
            assert compiled.execute(3).get(timeout=60) == 8
        finally:
            compiled.teardown()
        # the actor is released and serves normal calls again
        assert ray_tpu_torch.get(acc.add.remote(2), timeout=60) == 10
        ray_tpu_torch.kill(acc)

    def test_two_nodes_one_actor_single_loop(self, ray4):
        @ray_tpu_torch.remote
        class Calc:
            def inc(self, x):
                return x + 1

            def mul(self, x):
                return x * 10

        c = Calc.remote()
        with InputNode() as inp:
            dag = c.mul.bind(c.inc.bind(inp))
        compiled = dag.experimental_compile()
        try:
            assert compiled.execute(4).get(timeout=60) == 50
            assert compiled.execute(0).get(timeout=60) == 10
        finally:
            compiled.teardown()
        ray_tpu_torch.kill(c)

    def test_mixed_actor_and_function_stages(self, ray4, fns):
        @ray_tpu_torch.remote
        class Offset:
            def __init__(self, base):
                self.base = base

            def apply(self, x):
                return x + self.base

        off = Offset.remote(100)
        with InputNode() as inp:
            dag = fns.plus_one.bind(off.apply.bind(fns.times_two.bind(inp)))
        compiled = dag.experimental_compile()
        try:
            assert compiled.execute(5).get(timeout=60) == 111
        finally:
            compiled.teardown()
        ray_tpu_torch.kill(off)


class TestCompiledErrors:
    def test_stage_error_propagates_and_pipeline_survives(self, ray4, fns):
        @ray_tpu_torch.remote
        def maybe_boom(x):
            if x < 0:
                raise ValueError("negative!")
            return x + 1

        with InputNode() as inp:
            dag = fns.times_two.bind(maybe_boom.bind(inp))
        compiled = dag.experimental_compile()
        try:
            assert compiled.execute(1).get(timeout=60) == 4
            with pytest.raises(ValueError, match="negative"):
                compiled.execute(-1).get(timeout=60)
            # the loops survive the error: later executions still work
            assert compiled.execute(2).get(timeout=60) == 6
        finally:
            compiled.teardown()

    def test_dead_stage_teardown_unwedges_user_actor(self, ray4, fns):
        """A function stage dies mid-pipeline: the graceful sentinel can't
        propagate past it, so teardown must seal the force-stop token and
        the user actor's loop must exit; the actor serves calls again."""
        @ray_tpu_torch.remote
        class Keeper:
            def bump(self, x):
                return x + 1

            def ping(self):
                return "alive"

        k = Keeper.remote()
        with InputNode() as inp:
            dag = k.bump.bind(fns.plus_one.bind(inp))
        compiled = dag.experimental_compile()
        assert compiled.execute(1).get(timeout=60) == 3
        # kill the function stage's dedicated actor process
        ray_tpu_torch.kill(compiled._stage_actors[0])
        time.sleep(0.5)
        compiled.teardown(timeout=8.0)
        # the user actor's loop exited via the stop token: normal calls work
        assert ray_tpu_torch.get(k.ping.remote(), timeout=60) == "alive"
        ray_tpu_torch.kill(k)

    def test_execute_after_teardown_raises(self, ray4, fns):
        with InputNode() as inp:
            dag = fns.plus_one.bind(inp)
        compiled = dag.experimental_compile()
        compiled.teardown()
        with pytest.raises(RuntimeError, match="torn down"):
            compiled.execute(1)

    def test_input_only_graph_rejected(self, ray4):
        inp = InputNode()
        with pytest.raises(ValueError):
            CompiledDAG(inp)

    def test_get_timeout_is_absolute_across_catchup(self, ray4):
        """get(timeout=t) lagging N executions behind must honor one
        absolute deadline across its whole catch-up loop, not hand each
        buffered execution's channel read a fresh copy of t."""
        @ray_tpu_torch.remote
        def slow_bump(x):
            import time

            time.sleep(0.4)
            return x + 1

        with InputNode() as inp:
            dag = slow_bump.bind(inp)
        compiled = dag.experimental_compile()
        try:
            compiled.execute(0).get(timeout=60)  # warm the loop
            refs = [compiled.execute(i) for i in range(4)]
            t0 = time.perf_counter()
            # the last ref needs ~1.6 s of pipeline progress; a 0.5 s get
            # must raise at ~0.5 s
            with pytest.raises(TimeoutError):
                refs[-1].get(timeout=0.5)
            elapsed = time.perf_counter() - t0
            assert elapsed < 1.4, (
                f"get(timeout=0.5) blocked {elapsed:.2f}s: timeout is "
                "being re-applied per channel read, not per call")
            # the results are still deliverable afterwards
            assert [r.get(timeout=60) for r in refs] == [1, 2, 3, 4]
        finally:
            compiled.teardown()


class TestCompiledSpeed:
    def test_repeat_execution_beats_eager(self, ray4, fns):
        """The point of compiling: repeat executions skip per-call task
        submission entirely. Both sides measure best-of-3, and compiled
        must be at least 1.25x faster than eager, as in the JAX
        package's test."""
        with InputNode() as inp:
            dag = fns.plus_one.bind(fns.times_two.bind(fns.plus_one.bind(inp)))

        n = 30
        # warm the eager path (worker leases), then time it
        ray_tpu_torch.get(dag.execute(0), timeout=120)
        eager_s = 1e9
        for _ in range(3):
            t0 = time.perf_counter()
            for i in range(n):
                ray_tpu_torch.get(dag.execute(i), timeout=120)
            eager_s = min(eager_s, time.perf_counter() - t0)

        compiled = dag.experimental_compile()
        try:
            compiled.execute(0).get(timeout=120)  # warm the loops
            compiled_s = 1e9
            for _ in range(3):
                t0 = time.perf_counter()
                for i in range(n):
                    compiled.execute(i).get(timeout=120)
                compiled_s = min(compiled_s, time.perf_counter() - t0)
        finally:
            compiled.teardown()
        assert compiled_s < eager_s / 1.25, (
            f"compiled {compiled_s:.3f}s not >= 1.25x faster than eager "
            f"{eager_s:.3f}s")


# ------------------------------------------------ the port beside the JAX one
def test_visualize_matches_jax(ray4):
    """The same graph gives the same DOT text in both packages. The JAX
    side's actor node gets a stand-in handle: ``visualize`` reads only its
    class name."""
    from ray_tpu.dag import ClassMethodNode as JClassMethodNode
    from ray_tpu.dag import InputNode as JInputNode

    plus_one, times_two, add = _plain_fns()

    @ray_tpu_torch.remote
    class V:
        def go(self, x):
            return x

    v = V.remote()
    tr = [ray_tpu_torch.remote(f) for f in (plus_one, times_two, add)]
    with InputNode() as inp:
        a = tr[0].bind(inp["a"])
        dag = v.go.bind(tr[2].bind(a, tr[1].bind(inp.b)), a)
    jr = [ray_tpu.remote(f) for f in (plus_one, times_two, add)]
    with JInputNode() as jinp:
        ja = jr[0].bind(jinp["a"])
        jdag = JClassMethodNode(types.SimpleNamespace(_class_name="V"), "go",
                                (jr[2].bind(ja, jr[1].bind(jinp.b)), ja), {})
    assert dag.visualize() == jdag.visualize()
    ray_tpu_torch.kill(v)


def test_bind_builds_nodes_without_a_runtime_call():
    """``fn.bind`` and ``fn.options(...).bind`` give function nodes, and an
    actor method's ``bind`` a class-method node: none raises
    ``NotImplementedError`` as the port did before it had the DAG."""
    from ray_tpu_torch.actor import ActorHandle, ActorMethod
    from ray_tpu_torch.dag import ClassMethodNode, FunctionNode

    fn = ray_tpu_torch.remote(_plain_fns()[0])
    assert isinstance(fn.bind(1), FunctionNode)
    assert isinstance(fn.options(num_cpus=1).bind(1), FunctionNode)
    handle = ActorHandle.__new__(ActorHandle)
    method = ActorMethod(handle, "go")
    node = method.bind(2)
    assert isinstance(node, ClassMethodNode) and node._method_name == "go"
    assert isinstance(method.options(num_returns=1).bind(2), ClassMethodNode)


def test_half_gpu_stage_sees_its_device(ray4):
    """A ``{"GPU": 0.5}`` actor stage of a compiled graph, on a runtime
    with one GPU declared, runs with ``CUDA_VISIBLE_DEVICES`` set."""
    @ray_tpu_torch.remote
    class Stage:
        def visible(self, x):
            import os

            return x, os.environ.get("CUDA_VISIBLE_DEVICES")

    s = Stage.options(num_gpus=0.5).remote()
    with InputNode() as inp:
        dag = s.visible.bind(inp)
    compiled = dag.experimental_compile()
    try:
        assert compiled.execute(7).get(timeout=60) == (7, "0")
    finally:
        compiled.teardown()
    ray_tpu_torch.kill(s)


def test_gpu_function_node_takes_a_gpu_lease(ray4):
    """An uncompiled function node with ``num_gpus=1`` runs as a task
    through the lease path: its worker sees ``CUDA_VISIBLE_DEVICES``."""
    @ray_tpu_torch.remote(num_gpus=1)
    def visible(x):
        import os

        return x, os.environ.get("CUDA_VISIBLE_DEVICES")

    with InputNode() as inp:
        dag = visible.bind(inp)
    assert ray_tpu_torch.get(dag.execute(3), timeout=60) == (3, "0")


# ---------------------------------------------- two stages of a small Llama
_SMALL = dict(vocab_size=128, hidden=64, mlp_hidden=176, num_layers=2,
              num_heads=4, num_kv_heads=2, head_dim=16, max_seq_len=128,
              remat=False)


def _llama_stage_class():
    """A stage of the Llama, made here so that it travels by value: layers
    [lo, hi), with the embedding when lo is 0 and the final norm and
    ``lm_head`` when hi is the last layer; it returns the residual stream,
    or the last position's logits of ``llama_forward``'s product."""

    class LlamaStage:
        def __init__(self, params_np, cfg, lo, hi):
            import torch

            from ray_tpu_torch.models.llama import params_from_jax

            torch.set_num_threads(1)
            params = params_from_jax(params_np)
            self.cfg = cfg
            self.layers = [{n: w[i] for n, w in params["layers"].items()}
                           for i in range(lo, hi)]
            self.embed = params["embed"] if lo == 0 else None
            last = hi == cfg.num_layers
            self.final_norm = params["final_norm"] if last else None
            self.lm_head = params["lm_head"] if last else None

        def forward(self, x):
            import numpy as np
            import torch
            import torch.nn.functional as F

            from ray_tpu_torch.models.llama import _layer, _proj, _rms_norm

            cfg = self.cfg
            with torch.no_grad():
                if self.embed is not None:
                    h = F.embedding(torch.from_numpy(np.array(x)),
                                    self.embed).to(cfg.dtype)
                else:
                    h = x
                B, S = h.shape[:2]
                positions = torch.arange(S).expand(B, S)
                for lp in self.layers:
                    h = _layer(cfg, h, lp, positions, {}, 0.0)
                if self.lm_head is not None:
                    h = _rms_norm(h, self.final_norm, cfg.rms_eps)
                    h = _proj("bsh,hv->bsv", h,
                              self.lm_head.to(cfg.dtype)).float()[:, -1]
            return h.contiguous()

    return LlamaStage


def _small_llama_params(jc, seed):
    """The JAX package's param tree for ``jc``, drawn with numpy."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda: jl.init_llama(jc, jax.random.PRNGKey(0)))

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "norm" in name:
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)
                    ).astype(np.float32)
        return (rng.standard_normal(leaf.shape) * 0.2).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def test_two_stage_llama_dag_matches(ray4):
    """InputNode -> stage A (embedding, layer 0) -> stage B (layer 1, norm,
    lm_head), compiled: the last position's logits equal the port's
    ``llama_forward`` bit for bit and the JAX package's within 1e-4
    (fp32), in each of 3 executions."""
    jc = jl.LlamaConfig(**_SMALL, dtype=jnp.float32)
    tc = tl.LlamaConfig(**_SMALL, dtype=torch.float32)
    params = _small_llama_params(jc, seed=17)
    tokens = np.random.RandomState(3).randint(
        0, jc.vocab_size, (2, 16)).astype(np.int64)
    # the stages start (and import torch) while the references run here
    Stage = ray_tpu_torch.remote(_llama_stage_class())
    a = Stage.remote(params, tc, 0, 1)
    b = Stage.remote(params, tc, 1, 2)
    want_jax = np.asarray(jax.jit(lambda p, t: jl.llama_forward(p, t, jc))(
        params, jnp.asarray(tokens, jnp.int32)))[:, -1]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.no_grad():
            want = tl.llama_forward(tl.params_from_jax(params),
                                    torch.from_numpy(tokens), tc)[:, -1]
    finally:
        torch.set_num_threads(n)

    with InputNode() as inp:
        dag = b.forward.bind(a.forward.bind(inp))
    compiled = dag.experimental_compile()
    try:
        outs = [compiled.execute(tokens).get(timeout=120) for _ in range(3)]
    finally:
        compiled.teardown()
    for got in outs:
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert torch.equal(got, want)
        np.testing.assert_allclose(got.numpy(), want_jax, atol=1e-4,
                                   rtol=1e-4)
    ray_tpu_torch.kill(a)
    ray_tpu_torch.kill(b)
