# Copied from ray_tpu/dag.py (ray_tpu -> ray_tpu_torch, RAY_TPU_ -> RAY_TPU_TORCH_).
"""Lazy task/actor DAGs (reference: python/ray/dag/ — DAGNode
dag_node.py:25, InputNode/OutputNode, CompiledDAG
compiled_dag_node.py:141).

``fn.bind(*args)`` builds the graph lazily; ``dag.execute(input)`` walks it,
submitting each node as a task with upstream ObjectRefs as args (so the
object store pipelines the whole graph without materializing on the
driver). ``dag.experimental_compile()`` returns a :class:`CompiledDAG`:
the graph is planned ONCE, every edge becomes a pre-allocated
shared-memory :class:`~ray_tpu_torch.experimental.channel.Channel`, and every
compute node runs a PERSISTENT executor loop in its worker/actor process
— repeat ``execute()`` calls cost channel writes/reads only, with zero
per-call task submissions (reference: compiled_dag_node.py:141 +
experimental/channel.py:171). On a GPU the intended use is chaining
stages that each hold their part of a model on the card: a tensor crosses a
channel through the host (the serializer brings a CUDA tensor to the host
and the reader gets a CPU tensor), so a GPU stage moves what it reads to
its card.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import ray_tpu_torch


class DAGNode:
    def __init__(self, bound_args: tuple, bound_kwargs: dict):
        self._bound_args = bound_args
        self._bound_kwargs = bound_kwargs

    # ------------------------------------------------------------ execute
    def execute(self, *input_args, **input_kwargs):
        """Run the whole DAG; returns the final ObjectRef (or value for
        InputNode-only graphs)."""
        cache: Dict[int, Any] = {}
        return self._execute_node(cache, input_args, input_kwargs)

    def _resolve_arg(self, arg, cache, input_args, input_kwargs):
        if isinstance(arg, DAGNode):
            return arg._execute_node(cache, input_args, input_kwargs)
        return arg

    def _execute_node(self, cache, input_args, input_kwargs):
        raise NotImplementedError

    def experimental_compile(self) -> "CompiledDAG":
        return CompiledDAG(self)

    def visualize(self, filename: Optional[str] = None) -> str:
        """GraphViz DOT text for the DAG (reference: dag_node.py
        visualization via graphviz — emitted here as dependency-free DOT;
        pipe to `dot -Tsvg` to render). Writes ``filename`` if given."""
        lines = ["digraph dag {", "  rankdir=LR;"]
        seen: Dict[int, str] = {}

        def label(n: "DAGNode") -> str:
            if isinstance(n, InputNode):
                raw = "INPUT"
            elif isinstance(n, InputAttributeNode):
                raw = f"INPUT[{n._key!r}]"
            elif isinstance(n, MultiOutputNode):
                raw = "OUTPUT"
            elif isinstance(n, FunctionNode):
                fn = n._remote_fn
                raw = getattr(fn, "__name__", None) or getattr(
                    getattr(fn, "_function", None), "__name__", "task")
            elif isinstance(n, ClassMethodNode):
                raw = f"{n._actor._class_name}.{n._method_name}"
            else:
                raw = type(n).__name__
            # DOT double-quoted strings: escape embedded quotes/backslashes
            return raw.replace("\\", "\\\\").replace('"', '\\"')

        def visit(n: "DAGNode") -> str:
            if id(n) in seen:
                return seen[id(n)]
            name = f"n{len(seen)}"
            seen[id(n)] = name
            shape = ("ellipse" if isinstance(
                n, (InputNode, InputAttributeNode, MultiOutputNode))
                else "box")
            lines.append(f'  {name} [label="{label(n)}", shape={shape}];')
            deps = list(n._bound_args) + list(n._bound_kwargs.values())
            if isinstance(n, InputAttributeNode):
                deps = [n._parent]
            for d in deps:
                if isinstance(d, DAGNode):
                    lines.append(f"  {visit(d)} -> {name};")
            return name

        visit(self)
        lines.append("}")
        dot = "\n".join(lines)
        if filename:
            with open(filename, "w") as f:
                f.write(dot)
        return dot


def _pack_input(input_args: tuple, input_kwargs: dict) -> Any:
    """The one input-packing rule shared by eager InputNode resolution
    and CompiledDAG.execute — the two paths must never diverge."""
    if len(input_args) == 1 and not input_kwargs:
        return input_args[0]
    if input_kwargs and not input_args:
        return input_kwargs
    return input_args


class InputNode(DAGNode):
    """Placeholder for execute()-time input (reference: dag/input_node.py).

    Supports ``with InputNode() as inp:`` for API parity, plus
    ``inp[key]`` / ``inp.attr`` projections (reference:
    dag/input_node.py InputAttributeNode) usable in both eager and
    compiled execution."""

    def __init__(self):
        super().__init__((), {})

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __getitem__(self, key) -> "InputAttributeNode":
        return InputAttributeNode(self, key, "getitem")

    def __getattr__(self, name: str) -> "InputAttributeNode":
        if name.startswith("_"):
            raise AttributeError(name)
        return InputAttributeNode(self, name, "getattr")

    def _execute_node(self, cache, input_args, input_kwargs):
        return _pack_input(input_args, input_kwargs)


class InputAttributeNode(DAGNode):
    """A projection of the runtime input — ``inp[0]``, ``inp["x"]``,
    ``inp.field`` (reference: dag/input_node.py InputAttributeNode)."""

    def __init__(self, parent: InputNode, key, kind: str):
        super().__init__((), {})
        self._parent = parent
        self._key = key
        self._kind = kind

    def _extract(self, value):
        if self._kind == "getattr":
            if isinstance(value, dict):
                return value[self._key]
            return getattr(value, self._key)
        return value[self._key]

    def _execute_node(self, cache, input_args, input_kwargs):
        return self._extract(
            self._parent._execute_node(cache, input_args, input_kwargs))


class FunctionNode(DAGNode):
    def __init__(self, remote_fn, args: tuple, kwargs: dict):
        super().__init__(args, kwargs)
        self._remote_fn = remote_fn

    def _execute_node(self, cache, input_args, input_kwargs):
        key = id(self)
        if key not in cache:
            args = [self._resolve_arg(a, cache, input_args, input_kwargs)
                    for a in self._bound_args]
            kwargs = {k: self._resolve_arg(v, cache, input_args,
                                           input_kwargs)
                      for k, v in self._bound_kwargs.items()}
            cache[key] = self._remote_fn.remote(*args, **kwargs)
        return cache[key]


class ClassMethodNode(DAGNode):
    def __init__(self, actor_handle, method_name: str, args: tuple,
                 kwargs: dict, opts: Optional[dict] = None):
        super().__init__(args, kwargs)
        self._actor = actor_handle
        self._method_name = method_name
        self._opts = opts

    def _execute_node(self, cache, input_args, input_kwargs):
        key = id(self)
        if key not in cache:
            args = [self._resolve_arg(a, cache, input_args, input_kwargs)
                    for a in self._bound_args]
            kwargs = {k: self._resolve_arg(v, cache, input_args,
                                           input_kwargs)
                      for k, v in self._bound_kwargs.items()}
            method = getattr(self._actor, self._method_name)
            if self._opts:
                method = method.options(**self._opts)
            cache[key] = method.remote(*args, **kwargs)
        return cache[key]


class MultiOutputNode(DAGNode):
    """Terminal node collecting several branches
    (reference: dag/output_node.py)."""

    def __init__(self, outputs: List[DAGNode]):
        super().__init__(tuple(outputs), {})

    def _execute_node(self, cache, input_args, input_kwargs):
        return [self._resolve_arg(o, cache, input_args, input_kwargs)
                for o in self._bound_args]


class _Sentinel:
    """Teardown marker: propagates through every channel so all stage
    loops exit at the same iteration index."""


class _StageError:
    """A stage exception travels the pipeline as a value (the loop stays
    alive — reference compiled DAGs tear down on error; keeping the
    pipeline healthy lets later executions proceed)."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class _StopLoop(Exception):
    """Raised inside a stage loop when the DAG's force-stop token appears
    (teardown after a dead stage wedged the graceful sentinel path)."""


def _stop_requested(stop_id) -> bool:
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch._private.ids import ObjectID

    if stop_id is None:
        return False
    return worker_mod.global_worker.store.contains(ObjectID(stop_id))


def _read_with_stop(ch, stop_id):
    """Blocking channel read that stays interruptible: if an upstream
    stage died, the graceful sentinel can never arrive — the driver seals
    the stop token instead and the read resolves to a sentinel, so a
    USER actor hosting a loop is never wedged forever. The poll phase
    carries across retries so an idle loop settles into cheap sleeps."""
    phase = 0
    while True:
        try:
            return ch.read(timeout=2.0, _phase=phase)
        except TimeoutError as e:
            phase = getattr(e, "phase", phase)
            if _stop_requested(stop_id):
                return _Sentinel()


def _write_with_stop(ch, value, stop_id):
    """Blocking (backpressured) channel write, interruptible like reads.
    Channel.write only raises BEFORE writing, so retrying is safe."""
    phase = 0
    while True:
        try:
            ch.write(value, timeout=2.0, _phase=phase)
            return
        except TimeoutError as e:
            phase = getattr(e, "phase", phase)
            if _stop_requested(stop_id):
                raise _StopLoop()


def _multi_stage_body(stages, stop_id=None):
    """The persistent executor loop a compiled-DAG worker/actor runs.

    ``stages``: list of ``(call, args_desc, kwargs_desc, in_chs, out_chs)``
    in topological order (one entry for function stages; all of one
    actor's nodes share a single loop — a second blocking loop on the same
    actor would queue forever behind the first).

    Per iteration, per stage: read each distinct input channel ONCE (in
    fixed order), resolve bound args from read values + constants, run the
    call, write the result to every output channel. A sentinel read
    propagates to the stage's outputs; the loop exits after the pass so
    every channel is drained exactly once.
    """
    try:
        while True:
            stop = False
            for call, args_desc, kwargs_desc, in_chs, out_chs in stages:
                vals = [_read_with_stop(ch, stop_id) for ch in in_chs]
                if any(isinstance(v, _Sentinel) for v in vals):
                    stop = True
                    for ch in out_chs:
                        _write_with_stop(ch, _Sentinel(), stop_id)
                    continue
                err = next((v for v in vals if isinstance(v, _StageError)),
                           None)
                if err is None:
                    args = [vals[d[1]] if d[0] == "c" else d[1]
                            for d in args_desc]
                    kwargs = {k: (vals[d[1]] if d[0] == "c" else d[1])
                              for k, d in kwargs_desc.items()}
                    try:
                        result = call(*args, **kwargs)
                    except BaseException as e:  # noqa: BLE001 — crosses wire
                        result = _StageError(e)
                else:
                    result = err  # upstream failed: forward, don't call
                for ch in out_chs:
                    # a result that fails to SERIALIZE must forward as a
                    # _StageError, not kill the loop: a dead loop wedges
                    # every downstream read until the force-stop token
                    try:
                        _write_with_stop(ch, result, stop_id)
                    except _StopLoop:
                        raise
                    except BaseException as e:  # noqa: BLE001
                        try:
                            _write_with_stop(ch, _StageError(e), stop_id)
                        except _StopLoop:
                            raise
                        except BaseException:
                            # the exception itself is unserializable:
                            # forward a stringified stand-in
                            _write_with_stop(
                                ch,
                                _StageError(RuntimeError(
                                    f"{type(e).__name__}: {e}")),
                                stop_id)
            if stop:
                return "stopped"
    except _StopLoop:
        return "force-stopped"


def _actor_stage_apply(instance, specs, stop_id=None):
    """specs: list of (method_name, args_desc, kwargs_desc, in, out)."""
    return _multi_stage_body(
        [(getattr(instance, m), a, k, i, o) for m, a, k, i, o in specs],
        stop_id)


class _StageActor:
    """Dedicated executor process for a compiled function stage. A stage
    loop blocks its process for the DAG's lifetime, so it must NOT share a
    pooled task worker (the submitter pipelines tasks onto busy workers —
    two loops on one worker deadlock the pipeline). Hidden actors give
    each loop its own process, torn down with the DAG (the reference's
    compiled DAGs likewise run their loops inside dedicated actor
    processes, compiled_dag_node.py)."""

    def run(self, fn, args_desc, kwargs_desc, in_chs, out_chs,
            stop_id=None):
        return _multi_stage_body(
            [(fn, args_desc, kwargs_desc, in_chs, out_chs)], stop_id)


def _actor_node_id(handle) -> Optional[str]:
    """Node an actor currently lives on (from the head's actor table),
    or None when unknown (actor still PENDING / head unreachable)."""
    from ray_tpu_torch._private import worker as worker_mod

    w = worker_mod.global_worker
    if w is None or not w.connected:
        return None
    try:
        view = w._acall(
            w.head.call("GetActor", {"actor_id": handle._actor_id.hex()}),
            timeout=5)
    except Exception:
        return None
    return (view or {}).get("node_id") or None


_STAGE_ACTOR_CLS = None


def _stage_actor_cls():
    global _STAGE_ACTOR_CLS
    if _STAGE_ACTOR_CLS is None:
        # zero-CPU so an N-stage pipeline fits any node
        _STAGE_ACTOR_CLS = ray_tpu_torch.remote(num_cpus=0)(_StageActor)
    return _STAGE_ACTOR_CLS


class CompiledDAGRef:
    """Result handle for one ``CompiledDAG.execute`` call; ``ray_tpu_torch.get``
    unwraps it (reference: compiled_dag_node.py CompiledDAGRef)."""

    def __init__(self, dag: "CompiledDAG", seq: int):
        self._dag = dag
        self._seq = seq

    def get(self, timeout: Optional[float] = None) -> Any:
        return self._dag._result_for(self._seq, timeout)

    async def get_async(self, timeout: Optional[float] = None) -> Any:
        """Await the result without blocking the event loop (reference:
        CompiledDAGRef await support for async serving callers).

        Polls in short chunks so asyncio cancellation (wait_for) takes
        effect between chunks — a cancelled get must not leave a zombie
        thread camped on the DAG's consumer lock, and any worker thread
        outliving the cancellation is bounded by one chunk."""
        import asyncio

        deadline = None if timeout is None else \
            time.monotonic() + timeout
        while True:
            chunk = 2.0 if deadline is None else min(
                2.0, max(0.05, deadline - time.monotonic()))
            try:
                return await asyncio.to_thread(self.get, chunk)
            except TimeoutError:
                if deadline is not None and \
                        time.monotonic() >= deadline:
                    raise

    def __await__(self):
        return self.get_async().__await__()

    # duck-typed hook for ray_tpu_torch.get
    def _compiled_get(self, timeout: Optional[float] = None) -> Any:
        return self.get(timeout)

    def __repr__(self):
        return f"CompiledDAGRef(seq={self._seq})"


class CompiledDAG:
    """Channel-based precompiled execution (reference:
    compiled_dag_node.py:141).

    ``__init__`` plans the graph once: topological node order, one
    shared-memory channel per edge (plus driver input / output channels),
    then launches one persistent executor loop per compute node — function
    nodes on dedicated leased workers, actor-method nodes INSIDE their
    actor via the reserved ``__ray_apply__`` dispatch so state semantics
    match the eager path. ``execute()`` writes the input into the driver-
    fed channels and returns a :class:`CompiledDAGRef`; no tasks are
    submitted per call. Channel capacity bounds in-flight executions
    (backpressure = write blocks). Single-node scope, like the reference
    prototype.
    """

    def __init__(self, root: DAGNode, max_inflight: int = 8):
        from ray_tpu_torch.experimental.channel import Channel

        self._root = root
        self._capacity = max_inflight
        self._torn_down = False
        self._seq = 0          # executions issued
        self._next_read = 0    # next seq to read from output channels
        self._buffered: Dict[int, Any] = {}
        self._partial_input = None    # (value, next channel idx) on timeout
        self._partial_read: list = []  # output values read so far this seq
        self._discard_seqs: set = set()  # voided executions to drop
        # SPSC bookkeeping is single-writer/single-reader state. Two
        # INDEPENDENT locks so a backpressured producer (execute holding
        # the input lock across a blocking channel write) can never starve
        # the consumer that would drain the outputs and unblock it:
        #   _in_mu:  _seq, _partial_input, input-channel writes
        #   _out_mu: _next_read, _partial_read, _buffered, output reads
        # (_discard_seqs crosses the two; set add/discard are GIL-atomic)
        import threading

        self._in_mu = threading.RLock()
        self._out_mu = threading.RLock()

        # ---- plan: collect nodes reachable from root (post-order = topo)
        order: List[DAGNode] = []
        seen: Dict[int, DAGNode] = {}

        def visit(n: DAGNode) -> None:
            if id(n) in seen:
                return
            seen[id(n)] = n
            for dep in n._bound_args:
                if isinstance(dep, DAGNode):
                    visit(dep)
            for dep in n._bound_kwargs.values():
                if isinstance(dep, DAGNode):
                    visit(dep)
            order.append(n)

        visit(root)
        if isinstance(root, InputNode):
            raise ValueError("InputNode cannot be the DAG root")
        compute = [n for n in order
                   if isinstance(n, (FunctionNode, ClassMethodNode))]
        if not compute:
            raise ValueError("compiled DAG needs at least one task/actor node")
        for n in order:
            if isinstance(n, MultiOutputNode) and n is not root:
                raise ValueError("MultiOutputNode must be the DAG root")
        # force-stop token: sealed by teardown when the graceful sentinel
        # path can't complete (a dead stage wedges downstream reads)
        import os as _os

        from ray_tpu_torch._private.ids import ObjectID as _OID

        self._stop_id = _os.urandom(_OID.SIZE)

        # ---- channels: one per (producer, consumer-node) edge
        def mkch() -> Channel:
            return Channel(capacity=self._capacity)

        edge_ch: Dict[Tuple[int, int], Channel] = {}
        # driver-written channels: (channel, extractor) — the extractor
        # projects the execute() input for InputAttributeNode edges
        self._input_channels: List[Tuple[Channel, Any]] = []
        node_in: Dict[int, List[Channel]] = {}
        node_in_idx: Dict[int, Dict[int, int]] = {}  # node -> dep id -> pos
        for n in compute:
            ins: List[Channel] = []
            idx: Dict[int, int] = {}
            deps = [d for d in list(n._bound_args)
                    + list(n._bound_kwargs.values())
                    if isinstance(d, DAGNode)]
            for d in deps:
                if id(d) in idx:
                    continue
                ch = mkch()
                edge_ch[(id(d), id(n))] = ch
                idx[id(d)] = len(ins)
                ins.append(ch)
                if isinstance(d, InputAttributeNode):
                    self._input_channels.append((ch, d._extract))
                elif isinstance(d, InputNode):
                    self._input_channels.append((ch, None))
            if not ins:
                # constant-only stage: a driver-fed tick channel triggers
                # one iteration per execute (and carries the sentinel)
                ch = mkch()
                ins.append(ch)
                self._input_channels.append((ch, None))
            node_in[id(n)] = ins
            node_in_idx[id(n)] = idx

        # driver-read output channels (root, or each MultiOutput branch)
        self._output_channels: List[Channel] = []
        node_out: Dict[int, List[Channel]] = {id(n): [] for n in compute}
        if isinstance(root, MultiOutputNode):
            for branch in root._bound_args:
                if not isinstance(branch, (FunctionNode, ClassMethodNode)):
                    raise ValueError(
                        "MultiOutputNode branches must be task/actor nodes")
                ch = mkch()
                node_out[id(branch)].append(ch)
                self._output_channels.append(ch)
        else:
            ch = mkch()
            node_out[id(root)].append(ch)
            self._output_channels.append(ch)
        for (prod, cons), ch in edge_ch.items():
            if prod in node_out:  # InputNode edges are driver-written
                node_out[prod].append(ch)

        # ---- launch persistent loops (one dedicated stage actor per
        # function node; all of a user actor's nodes share ONE loop, in
        # topo order). Channels are node-local shm: every participant
        # MUST live on the driver's node — stage actors are pinned there
        # via node affinity, and a user actor on a different node is a
        # compile-time error instead of a read that hangs forever.
        from ray_tpu_torch._private import worker as worker_mod

        driver_node = getattr(worker_mod.global_worker, "node_id", "")
        self._loop_refs = []
        self._stage_actors: List[Any] = []
        actor_specs: Dict[Any, List] = {}
        actor_handles: Dict[Any, Any] = {}
        checked_actors: set = set()
        for n in compute:
            if isinstance(n, ClassMethodNode):
                if n._actor._actor_id in checked_actors:
                    continue  # one GetActor RPC per actor, not per method
                checked_actors.add(n._actor._actor_id)
                actor_node = _actor_node_id(n._actor)
                if driver_node and actor_node and actor_node != driver_node:
                    raise ValueError(
                        f"compiled DAG actor {n._actor._class_name} "
                        f"(method {n._method_name!r}) lives on node "
                        f"{actor_node[:12]} but the driver is on "
                        f"{driver_node[:12]}: compiled-DAG channels are "
                        "node-local shared memory, so every participating "
                        "actor must be created on the driver's node (e.g. "
                        "with NodeAffinitySchedulingStrategy)")
        for n in compute:
            idx = node_in_idx[id(n)]

            def desc(v, idx=idx):
                return ("c", idx[id(v)]) if isinstance(v, DAGNode) \
                    else ("k", v)

            args_desc = [desc(a) for a in n._bound_args]
            kwargs_desc = {k: desc(v) for k, v in n._bound_kwargs.items()}
            if isinstance(n, FunctionNode):
                fn = n._remote_fn
                raw = getattr(fn, "_function", None) or fn
                stage_cls = _stage_actor_cls()
                if driver_node:
                    from ray_tpu_torch.util.scheduling_strategies import (
                        NodeAffinitySchedulingStrategy)

                    stage_cls = stage_cls.options(
                        scheduling_strategy=NodeAffinitySchedulingStrategy(
                            driver_node))
                stage = stage_cls.remote()
                self._stage_actors.append(stage)
                ref = stage.run.remote(
                    raw, args_desc, kwargs_desc,
                    node_in[id(n)], node_out[id(n)], self._stop_id)
                self._loop_refs.append(ref)
            else:
                key = n._actor._actor_id
                actor_handles[key] = n._actor
                actor_specs.setdefault(key, []).append(
                    (n._method_name, args_desc, kwargs_desc,
                     node_in[id(n)], node_out[id(n)]))
        for key, specs in actor_specs.items():
            from ray_tpu_torch.actor import ActorMethod

            apply_m = ActorMethod(actor_handles[key], "__ray_apply__")
            self._loop_refs.append(
                apply_m.remote(_actor_stage_apply, specs, self._stop_id))

    # -------------------------------------------------------------- execute
    def execute(self, *input_args, **input_kwargs) -> CompiledDAGRef:
        with self._in_mu:
            return self._execute_locked(input_args, input_kwargs)

    def _execute_locked(self, input_args, input_kwargs) -> CompiledDAGRef:
        if self._torn_down:
            raise RuntimeError("compiled DAG was torn down")
        input_val = _pack_input(input_args, input_kwargs)
        if self._partial_input is not None:
            # a previous execute timed out mid-write: finish delivering its
            # input FIRST so branches stay in lockstep. That voided call
            # never issued a ref, so its completed execution is discarded
            # transparently on the read side.
            val, idx = self._partial_input
            self._write_inputs(val, idx)  # progress saved if this raises
            self._partial_input = None
            self._discard_seqs.add(self._seq)
            self._seq += 1
        self._write_inputs(input_val, 0)
        ref = CompiledDAGRef(self, self._seq)
        self._seq += 1
        return ref

    async def execute_async(self, *input_args,
                            **input_kwargs) -> CompiledDAGRef:
        """execute() for asyncio callers: the (possibly backpressured)
        input-channel writes run off-loop (reference:
        compiled_dag_node.py execute_async)."""
        import asyncio
        from functools import partial

        return await asyncio.to_thread(
            partial(self.execute, *input_args, **input_kwargs))

    def _write_inputs(self, input_val: Any, start_idx: int) -> None:
        """Write one execution's input to every driver-fed channel,
        recording progress so a backpressure TimeoutError stays retry-safe
        (a partial write must never silently skew branch iterations)."""
        # project FIRST: a bad input (e.g. KeyError in an inp["x"]
        # extractor) must fail before ANY channel write, not mid-vector
        projected = [
            (extract(input_val) if extract is not None else input_val)
            for _ch, extract in self._input_channels[start_idx:]]
        for i, value in zip(range(start_idx, len(self._input_channels)),
                            projected):
            try:
                self._input_channels[i][0].write(value)
            except TimeoutError:
                if i > 0 or start_idx > 0:
                    # genuinely partial: must resume with THIS value
                    self._partial_input = (input_val, i)
                # else nothing was written — plain retry-safe backpressure
                raise

    def _result_for(self, seq: int, timeout: Optional[float]) -> Any:
        # honor a finite timeout on the LOCK acquisition too — a 0.5s get
        # must not wait forever behind another getter holding the lock in
        # an unbounded read
        deadline = None if timeout is None else time.monotonic() + timeout
        if not self._out_mu.acquire(
                timeout=-1 if timeout is None else timeout):
            raise TimeoutError(
                f"result for execution #{seq} blocked behind another "
                "consumer past the timeout")
        try:
            remaining = None if deadline is None else max(
                0.005, deadline - time.monotonic())
            return self._result_for_locked(seq, remaining)
        finally:
            self._out_mu.release()

    def _result_for_locked(self, seq: int, timeout: Optional[float]) -> Any:
        # one absolute deadline for the WHOLE call: each channel read gets
        # the time remaining, not a fresh copy of the user's timeout (a
        # get(timeout=t) over N channels × M buffered seqs must not be
        # able to block ~N*M*t)
        deadline = None if timeout is None else time.monotonic() + timeout
        if seq in self._buffered:
            out = self._buffered.pop(seq)
        else:
            if seq < self._next_read:
                raise ValueError(
                    f"result for execution #{seq} was already consumed")
            if self._torn_down:
                raise RuntimeError("compiled DAG was torn down")
            while self._next_read <= seq:
                out = self._read_output_vector(deadline)
                if self._next_read in self._discard_seqs:
                    # a voided (timed-out) execution's result: drop it
                    self._discard_seqs.discard(self._next_read)
                    self._next_read += 1
                    continue
                if self._next_read == seq:
                    self._next_read += 1
                    break
                self._buffered[self._next_read] = out
                self._next_read += 1
        errs = out if isinstance(out, list) else [out]
        for v in errs:
            if isinstance(v, _StageError):
                raise v.exc
        return out

    # between blocking-read chunks, check the stage loops for EARLY death
    # so a killed stage surfaces as an error instead of a hang
    _LIVENESS_POLL_S = 1.0

    def _raise_if_stage_dead(self) -> None:
        """A stage loop that completed while the DAG is live means a dead
        stage (loops only return at teardown): surface its error — a
        SIGKILL'd stage process otherwise leaves every downstream channel
        empty and ``CompiledDAGRef.get()`` blocked forever."""
        if self._torn_down or not self._loop_refs:
            return
        try:
            done, _ = ray_tpu_torch.wait(list(self._loop_refs), num_returns=1,
                                   timeout=0)
        except Exception:
            return
        if not done or self._torn_down:
            return
        try:
            ray_tpu_torch.get(done[0], timeout=5.0)
        except Exception as e:
            raise RuntimeError(
                "compiled DAG stage died mid-pipeline: "
                f"{type(e).__name__}: {e}") from e
        raise RuntimeError(
            "compiled DAG stage loop exited unexpectedly (worker killed "
            "or loop crashed); tear the DAG down and recompile")

    def _read_output_vector(self, deadline: Optional[float]) -> Any:
        """Read one value from every output channel. Partial progress is
        buffered across calls (``_partial_read``) so a user timeout on a
        slow branch stays retry-safe instead of skewing branch pairs.
        deadline=None blocks indefinitely, matching eager ray_tpu_torch.get —
        but reads are chunked so dead stages are detected either way."""
        vals = self._partial_read
        while len(vals) < len(self._output_channels):
            ch = self._output_channels[len(vals)]
            phase = 0
            while True:
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                # an expired deadline still attempts one timeout=0 read:
                # get(timeout=0) is the documented nonblocking poll and
                # must return a READY result, not raise unconditionally
                chunk = self._LIVENESS_POLL_S if remaining is None \
                    else min(self._LIVENESS_POLL_S, max(0.0, remaining))
                try:
                    vals.append(ch.read(timeout=chunk, _phase=phase))
                    break
                except TimeoutError as e:
                    phase = getattr(e, "phase", phase)
                    if remaining is not None and remaining <= 0:
                        raise TimeoutError(
                            "compiled DAG result not ready within timeout")
                    self._raise_if_stage_dead()
        self._partial_read = []
        return vals if len(self._output_channels) > 1 else vals[0]

    # ------------------------------------------------------------- teardown
    def teardown(self, timeout: float = 30.0) -> None:
        """Stop every stage loop and release the channels."""
        if self._torn_down:
            return
        self._torn_down = True
        # the input channels are SPSC — the sentinel writes must not race
        # a concurrent execute's writes. If a wedged execute holds the
        # lock (blocked on backpressure), seal the stop token so the
        # pipeline unwedges; the writer's own timeout then releases it.
        if not self._in_mu.acquire(timeout=min(timeout, 5.0)):
            self._seal_stop_token()
            self._in_mu.acquire()
        try:
            for ch, _extract in self._input_channels:
                try:
                    ch.write(_Sentinel(), timeout=timeout)
                except Exception:
                    pass
        finally:
            self._in_mu.release()
        # drain pending results + the sentinel so every slot is consumed;
        # skip if a getter camps on the consumer lock (force-stop covers)
        deadline = time.monotonic() + timeout
        if self._out_mu.acquire(timeout=min(timeout, 5.0)):
            try:
                for ch in self._output_channels:
                    while time.monotonic() < deadline:
                        try:
                            v = ch.read(timeout=max(
                                0.1, deadline - time.monotonic()))
                        except Exception:
                            break
                        if isinstance(v, _Sentinel):
                            break
            finally:
                self._out_mu.release()
        try:
            ray_tpu_torch.get(self._loop_refs, timeout=timeout)
        except Exception:
            # graceful sentinel drain failed (a stage died mid-pipeline and
            # can't forward its sentinel): seal the force-stop token so
            # every surviving loop — including loops INSIDE user actors —
            # unwedges within its 2 s read poll instead of blocking forever
            self._seal_stop_token()
            try:
                # loops poll the stop token every ~2s; don't exceed the
                # caller's budget (__del__ tears down with timeout=2)
                ray_tpu_torch.get(self._loop_refs, timeout=min(timeout, 15.0))
            except Exception:
                pass
        for stage in self._stage_actors:
            try:
                ray_tpu_torch.kill(stage)
            except Exception:
                pass
        self._stage_actors = []

    def _seal_stop_token(self) -> None:
        from ray_tpu_torch._private import worker as worker_mod
        from ray_tpu_torch._private.ids import ObjectID

        try:
            w = worker_mod.global_worker
            oid = ObjectID(self._stop_id)
            if not w.store.contains(oid):
                view, handle = w.store.create(oid, 1)
                view[0:1] = b"\x01"
                w.store.seal(oid, handle)
        except Exception:
            pass

    def __del__(self):
        try:
            if not self._torn_down:
                self.teardown(timeout=2.0)
        except Exception:
            pass
