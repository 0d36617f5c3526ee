# Copied from ray_tpu/_private/worker.py (ray_tpu -> ray_tpu_torch, RAY_TPU_ -> RAY_TPU_TORCH_).
"""Core worker runtime — the per-process engine behind the public API.

Parity with the reference core worker (reference:
``src/ray/core_worker/core_worker.h:290``): every driver and worker process
embeds one ``Worker`` owning (a) the serialization context, (b) an in-process
memory store for small objects, (c) the ownership table / reference counter
(reference: ``reference_count.h:61``), (d) the task manager with retry +
lineage state (reference: ``task_manager.h:195``), (e) the lease-based direct
task submitter (reference: ``transport/direct_task_transport.h:75``) and the
sequenced direct actor submitter (reference:
``transport/direct_actor_task_submitter.h:74``).

All networking runs on one background asyncio thread; public methods are
synchronous facades over it. Each process also runs a small "owner service"
server so any other process can resolve object values/locations directly from
the owner — the ownership model's decentralized object directory (reference:
``ownership_based_object_directory.h``).
"""

from __future__ import annotations

import asyncio
import hashlib
import os
import socket
import sys
import threading
import time
import weakref
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private import events as _events
from ray_tpu_torch._private import sanitizer as _sanitizer
from ray_tpu_torch._private import serialization as ser
from ray_tpu_torch._private.async_util import (
    DecorrelatedJitterBackoff, hold_task, spawn_tracked)
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.ids import ActorID, JobID, ObjectID, TaskID, WorkerID, _Counter
from ray_tpu_torch._private.memory_store import MemoryStore
from ray_tpu_torch._private.mux import (
    MuxPool, attach_batch_router as _attach_batch_router,
    handle_shm_attach, handle_shm_detach)
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.object_store import StoreClient, make_store_client
from ray_tpu_torch._private.protocol import (
    AsyncRpcClient,
    Connection,
    ConnectionPool,
    RpcError,
    RpcServer,
)
from ray_tpu_torch._private.task_spec import (
    ACTOR_CREATION_TASK,
    ACTOR_TASK,
    NORMAL_TASK,
    SpecTemplate,
    TaskSpec,
)
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    GetTimeoutError,
    NodeDiedError,
    ObjectLostError,
    ObjectReconstructionFailedError,
    RayActorError,
    RayTaskError,
    TaskCancelledError,
    WorkerCrashedError,
)

# Memory-store entry flags
VAL = 0
EXC = 1
IN_PLASMA = 2

global_worker: Optional["Worker"] = None


def _shm_stats() -> Dict:
    from ray_tpu_torch._private.shm_rpc import SHM_STATS

    return SHM_STATS


def node_ip() -> str:
    return os.environ.get("RAY_TPU_TORCH_NODE_IP", "127.0.0.1")


# Callsite interning: one tag string per (code object, line),
# so the per-put cost after the first hit at a site is two dict probes.
# Bounded by clear-on-cap rather than eviction — real programs have a
# few hundred distinct put/remote sites, and a clear simply re-interns.
_CALLSITE_CACHE: Dict[tuple, str] = {}
_CALLSITE_CACHE_MAX = 4096
_RAY_TPU_PKG_DIR = os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))) + os.sep


def _user_callsite(depth: int = 2) -> str:
    """``module:qualname:line`` of the nearest stack frame OUTSIDE the
    ray_tpu_torch package — the user's ``put()``/``.remote()`` call, even when
    it reached us through api/remote_function/data-plane layers. Falls
    back to the innermost frame when everything is framework code (e.g.
    internal shuffle puts: the data-plane callsite is still the right
    attribution target). Never raises."""
    try:
        f = sys._getframe(depth)
    except ValueError:
        return "<unknown>"
    inner = f
    hops = 0
    while f is not None and hops < 20:
        if not f.f_code.co_filename.startswith(_RAY_TPU_PKG_DIR):
            break
        f = f.f_back
        hops += 1
    if f is None:
        f = inner
    # pre-3.12 comprehensions run in their own "<listcomp>"-style frame:
    # fold into the enclosing function (same statement, readable name)
    while (f.f_code.co_name in ("<listcomp>", "<dictcomp>", "<setcomp>",
                                "<genexpr>")
           and f.f_back is not None
           and not f.f_back.f_code.co_filename.startswith(_RAY_TPU_PKG_DIR)):
        f = f.f_back
    code, line = f.f_code, f.f_lineno
    key = (code, line)
    tag = _CALLSITE_CACHE.get(key)
    if tag is None:
        mod = os.path.splitext(os.path.basename(code.co_filename))[0]
        qual = getattr(code, "co_qualname", None) or code.co_name
        tag = sys.intern(f"{mod}:{qual}:{line}")
        if len(_CALLSITE_CACHE) >= _CALLSITE_CACHE_MAX:
            _CALLSITE_CACHE.clear()
        _CALLSITE_CACHE[key] = tag
    return tag


class OwnedObjectMeta:
    __slots__ = ("state", "locations", "resolved_event",
                 # creation provenance: who made this object,
                 # where in the code, how big — the attribution the
                 # memory debugger / leak watchdog group by
                 "size", "created_at", "callsite", "creator", "creator_id")

    def __init__(self):
        self.state = "pending"  # pending | inline | plasma | error | freed
        self.locations: List[Dict] = []  # agent tcp addrs holding a copy
        self.resolved_event: Optional[asyncio.Event] = None
        self.size = 0
        self.created_at = 0.0
        self.callsite = ""       # interned module:qualname:line
        self.creator = ""        # "driver" | "task:<fn>" | "actor:<method>"
        self.creator_id = ""     # creating task id hex ("" for driver puts)


class ReferenceCounter:
    """Owner-side reference counts + object directory; borrower-side borrow
    registration (reference: src/ray/core_worker/reference_count.h)."""

    def __init__(self, worker: "Worker"):
        self.worker = worker
        self._lock = threading.RLock()
        self._local: Dict[bytes, int] = {}
        self._borrows: Dict[bytes, int] = {}  # owner side: remote borrowers
        self._task_pins: Dict[bytes, int] = {}
        self._owned: Dict[bytes, OwnedObjectMeta] = {}
        self._is_borrower: Dict[bytes, Dict] = {}  # binary -> owner addr

    # -- ownership -----------------------------------------------------------
    def register_owned(self, object_id: ObjectID,
                       callsite: str = "", creator: str = "",
                       creator_id: str = "",
                       size: int = 0) -> OwnedObjectMeta:
        """Idempotent; provenance fields are set on first registration
        only (a later register of the same id — streaming re-push, lineage
        re-execution — must not re-stamp created_at)."""
        with self._lock:
            meta = self._owned.get(object_id.binary())
            if meta is None:
                meta = OwnedObjectMeta()
                meta.created_at = time.time()
                meta.callsite = callsite
                meta.creator = creator
                meta.creator_id = creator_id
                meta.size = size
                self._owned[object_id.binary()] = meta
            return meta

    def register_owned_batch(self, entries: List[Tuple[bytes, str]],
                             callsite: str = "", creator: str = "") -> None:
        """Register many return ids under ONE lock acquisition and one
        timestamp — the owner-ref registration batch behind
        ``submit_many``. ``entries`` is ``[(object_binary, creator_id)]``;
        callsite/creator are shared (one submission site)."""
        now = time.time()
        with self._lock:
            owned = self._owned
            for e in entries:
                binary = e[0]
                if binary in owned:
                    continue  # idempotent, same as register_owned
                meta = OwnedObjectMeta()
                meta.created_at = now
                meta.callsite = callsite
                # a 3-tuple entry carries its own creator (mixed-method
                # actor batches); 2-tuples share the batch-level one
                meta.creator = e[2] if len(e) > 2 else creator
                meta.creator_id = e[1]
                owned[binary] = meta

    def set_resolved_batch(self, items: List[Tuple]) -> None:
        """Many resolutions, one lock pass. ``items`` is
        ``[(binary, state, size)]`` — inline/error resolutions only (the
        batched completion drain; plasma returns keep the per-id path for
        their location bookkeeping). Resolved events fire after the lock
        drops, same as :meth:`set_resolved`."""
        events = []
        with self._lock:
            owned = self._owned
            for binary, state, size in items:
                meta = owned.get(binary)
                if meta is None:
                    continue  # never resurrect (see set_resolved)
                meta.state = state
                if size is not None:
                    meta.size = size
                if meta.resolved_event is not None:
                    events.append(meta.resolved_event)
        for ev in events:
            self.worker._loop_call(ev.set)

    def get_owned_meta(self, binary: bytes) -> Optional[OwnedObjectMeta]:
        with self._lock:
            return self._owned.get(binary)

    def set_resolved(self, binary: bytes, state: str,
                     locations: Optional[List[Dict]] = None,
                     size: Optional[int] = None):
        with self._lock:
            meta = self._owned.get(binary)
            if meta is None:
                # NEVER resurrect: a reply landing after every ref was
                # dropped (free raced the task's completion) used to
                # re-create the owned entry here — with no ref left to
                # ever free it again, the entry (and its memory-store
                # value, written by the caller) leaked forever. Found by
                # the conftest ref-leak gate.
                return
            meta.state = state
            if size is not None:
                meta.size = size
            if locations:
                for loc in locations:
                    if loc not in meta.locations:
                        meta.locations.append(loc)
            ev = meta.resolved_event
        if ev is not None:
            self.worker._loop_call(ev.set)

    def add_location(self, binary: bytes, addr: Dict) -> bool:
        """Record a copy at ``addr``; False when the object is freed (or
        not owned here), so that the caller frees that copy."""
        with self._lock:
            meta = self._owned.get(binary)
            if meta is None or meta.state == "freed":
                return False
            if addr not in meta.locations:
                meta.locations.append(addr)
            return True

    def mark_freed(self, meta: "OwnedObjectMeta") -> Tuple[str, List[Dict]]:
        """Mark an owned object freed and hand back its state and the
        copies to free, under the lock ``add_location`` takes: a copy
        announced after this is refused there, never lost."""
        with self._lock:
            state, locations = meta.state, list(meta.locations)
            meta.state = "freed"
            meta.locations = []
        return state, locations

    # -- counting ------------------------------------------------------------
    def add_local_ref(self, ref: ObjectRef):
        with self._lock:
            self._local[ref.binary()] = self._local.get(ref.binary(), 0) + 1

    def remove_local_ref(self, ref: ObjectRef):
        free = False
        with self._lock:
            b = ref.binary()
            n = self._local.get(b, 0) - 1
            if n <= 0:
                self._local.pop(b, None)
                if b in self._is_borrower:
                    owner = self._is_borrower.pop(b)
                    self.worker._notify_owner_async(
                        owner, "RemoveBorrow", {"object_id": b.hex()}
                    )
                elif self._ready_to_free(b):
                    free = True
            else:
                self._local[b] = n
        if free:
            self.worker._free_owned(ref.binary())

    def on_ref_serialized(self, ref: ObjectRef):
        # Pinning for in-flight serialized refs is handled by task-arg pins;
        # nested refs inside values are also collected by the serializer.
        ctx = ser.get_reducer_context()
        collected = getattr(ctx, "collected_refs", None)
        if collected is not None:
            collected.append(ref)

    def on_ref_deserialized(self, ref: ObjectRef):
        with self._lock:
            b = ref.binary()
            self._local[b] = self._local.get(b, 0) + 1
            if b in self._owned:
                return  # we are the owner
            if ref.owner_addr() and ref.owner_addr().get("worker_id") != self.worker.worker_id.hex():
                if b not in self._is_borrower:
                    self._is_borrower[b] = ref.owner_addr()
                    self.worker._notify_owner_async(
                        ref.owner_addr(), "AddBorrow", {"object_id": b.hex()}
                    )

    def add_borrow(self, binary: bytes):
        with self._lock:
            self._borrows[binary] = self._borrows.get(binary, 0) + 1

    def remove_borrow(self, binary: bytes):
        free = False
        with self._lock:
            n = self._borrows.get(binary, 0) - 1
            if n <= 0:
                self._borrows.pop(binary, None)
                if self._ready_to_free(binary):
                    free = True
            else:
                self._borrows[binary] = n
        if free:
            self.worker._free_owned(binary)

    def clear_borrows(self, binary: bytes):
        """Owner-side forced borrow release. RemoveBorrow rides the
        borrower's ObjectRef GC, so a SIGKILLed borrower leaves the count
        stuck forever; the owner may clear it once it knows every
        borrower is dead or past any use of the object (e.g. retired
        elastic-train checkpoint shards). A late RemoveBorrow from a
        surviving borrower lands on an absent entry and is a no-op."""
        free = False
        with self._lock:
            if self._borrows.pop(binary, None) is not None \
                    and self._ready_to_free(binary):
                free = True
        if free:
            self.worker._free_owned(binary)

    def add_local_refs_batch(self, binaries: List[bytes]) -> None:
        """Local-ref registration for a block of freshly minted refs:
        one lock acquisition for the whole batch. Callers
        construct the ObjectRefs with ``_register=False`` and flip
        ``_registered`` after this lands."""
        with self._lock:
            local = self._local
            for b in binaries:
                local[b] = local.get(b, 0) + 1

    def pin_for_task(self, binary: bytes):
        with self._lock:
            self._task_pins[binary] = self._task_pins.get(binary, 0) + 1

    def unpin_for_task(self, binary: bytes):
        free = False
        with self._lock:
            n = self._task_pins.get(binary, 0) - 1
            if n <= 0:
                self._task_pins.pop(binary, None)
                if self._ready_to_free(binary):
                    free = True
            else:
                self._task_pins[binary] = n
        if free:
            self.worker._free_owned(binary)

    def _ready_to_free(self, binary: bytes) -> bool:
        return (
            binary in self._owned
            and self._local.get(binary, 0) <= 0
            and self._borrows.get(binary, 0) <= 0
            and self._task_pins.get(binary, 0) <= 0
        )

    def drop_owned(self, binary: bytes):
        with self._lock:
            self._owned.pop(binary, None)

    def stats(self) -> Dict:
        with self._lock:
            return {
                "num_owned": len(self._owned),
                "num_local_refs": len(self._local),
                "num_borrowed": len(self._is_borrower),
            }

    # -- introspection -------------------------------------------
    def dump(self, limit: int = 10000) -> Dict:
        """Snapshot of every ref table with provenance — the payload of
        the ``GetObjectRefs`` RPC the memory debugger aggregates."""
        with self._lock:
            owned = []
            for b, meta in list(self._owned.items())[:limit]:
                owned.append({
                    "object_id": b.hex(),
                    "state": meta.state,
                    "size_bytes": meta.size,
                    "created_at": meta.created_at,
                    "callsite": meta.callsite,
                    "creator": meta.creator,
                    "creator_id": meta.creator_id,
                    "local_refs": self._local.get(b, 0),
                    "borrowers": self._borrows.get(b, 0),
                    "task_pins": self._task_pins.get(b, 0),
                    "locations": len(meta.locations),
                })
            borrowed = [
                {"object_id": b.hex(),
                 "owner": dict(addr) if isinstance(addr, dict) else {},
                 "local_refs": self._local.get(b, 0)}
                for b, addr in list(self._is_borrower.items())[:limit]
            ]
            return {
                "owned": owned,
                "borrowed": borrowed,
                "counts": {
                    "owned": len(self._owned),
                    "local_refs": len(self._local),
                    "borrows": len(self._borrows),
                    "task_pins": len(self._task_pins),
                    "borrowed": len(self._is_borrower),
                },
            }

    def ref_info(self, binaries: List[bytes]) -> Dict[str, Dict]:
        """Per-id ownership verdict for the leak watchdog: does this
        process still hold ANY reason for the object to exist?"""
        out: Dict[str, Dict] = {}
        with self._lock:
            for b in binaries:
                meta = self._owned.get(b)
                out[b.hex()] = {
                    "owned": meta is not None,
                    "state": meta.state if meta is not None else "unknown",
                    "local_refs": self._local.get(b, 0),
                    "borrowers": self._borrows.get(b, 0),
                    "task_pins": self._task_pins.get(b, 0),
                    "callsite": meta.callsite if meta is not None else "",
                    "creator": meta.creator if meta is not None else "",
                    "size_bytes": meta.size if meta is not None else 0,
                }
        return out


class TaskRecord:
    __slots__ = ("spec", "attempts", "return_ids", "future", "cancelled",
                 "submitted_at", "completed", "streaming_gen", "callsite",
                 "reconstructions")

    def __init__(self, spec: TaskSpec, return_ids: List[ObjectID],
                 callsite: str = ""):
        self.spec = spec
        self.attempts = 0
        self.return_ids = return_ids
        self.cancelled = False
        self.completed = False
        self.submitted_at = time.time()
        # ObjectRefGenerator for num_returns=-1 streaming tasks
        self.streaming_gen = None
        # submit-site tag: provenance for streaming yields registered later
        self.callsite = callsite
        # lineage reconstruction replays of this task, bounded
        # by lineage_max_reconstruction_attempts — distinct from
        # `attempts`, which counts failure retries
        self.reconstructions = 0


def _replay_seed(task_binary: bytes) -> int:
    """Deterministic per-task RNG seed derived from the task id:
    the same value rides every resubmission of the spec, so
    a task body drawing randomness produces byte-identical returns on
    lineage replay."""
    return int.from_bytes(task_binary[:8], "little") & 0x7FFF_FFFF_FFFF_FFFF


def _span_since(record: "TaskRecord", name: str) -> None:
    """Record a submit->now phase slice (lease_wait / enqueue_wait) as a
    child of the task's root span. Callers pre-check
    ``record.spec.trace_ctx is not None`` so the unsampled path never
    pays the call."""
    rec = _events.REC
    if not rec.enabled:
        return
    tc = record.spec.trace_ctx
    now = time.time()
    rec.record(name, "task", record.submitted_at,
               max(0.0, now - record.submitted_at), tc[0], rec.next_id(),
               tc[1])


class LineageLedger:
    """Owner-side accounting for replayable task lineage (reference:
    task_manager.h lineage pinning + max_lineage_bytes evict-on-cap).

    A completed NORMAL_TASK whose plasma returns are still referenced is
    *retained*: its :class:`TaskRecord` stays in ``Worker._tasks`` and
    its argument refs stay task-pinned, so the whole producing chain can
    be replayed if a copy dies with a node. The ledger tracks, per
    retained task, the serialized-spec byte cost and the set of
    still-live return ids; a record is released (and its arg pins
    dropped, cascading up the chain) when its LAST live output ref dies,
    or evicted FIFO when total bytes exceed ``lineage_max_bytes`` —
    evicted objects simply become non-reconstructable.
    """

    def __init__(self, worker: "Worker"):
        self.worker = worker
        # RLock: on_output_freed/discard run in GC context
        # (ObjectRef.__del__ -> _free_owned) and may fire on the very
        # thread already holding this lock mid-critical-section
        self._lock = threading.RLock()
        # task_binary -> {"size": int, "live": set of return binaries};
        # insertion order = retention order = FIFO eviction order
        self._entries: "OrderedDict[bytes, Dict]" = OrderedDict()
        # replay observers (weak: a dead subscriber — a finished shuffle
        # exchange, say — drops out on the next notify, no unregister
        # protocol needed). Most losses resolve inside the owner's pull
        # path now, so a layer that used to drive its own re-execution
        # (and count it) has to HEAR about replays to keep its counters
        # truthful.
        self._listeners: List = []
        self.bytes = 0
        self.evictions = 0
        self.reconstructions = 0

    @staticmethod
    def _estimate(spec: TaskSpec) -> int:
        n = 512  # spec envelope (ids, resources, strategy, ...)
        n += len(spec.function_blob or b"")
        for entry in list(spec.args) + list(spec.kwargs.values()):
            for part in entry:
                if isinstance(part, (bytes, bytearray, memoryview)):
                    n += len(part)
        return n

    def retain(self, record: TaskRecord, live_outputs: List[bytes]) -> bool:
        """Idempotent: a reconstruction replay's second completion keeps
        the first retention's live-output set (outputs freed meanwhile
        must stay freed)."""
        task_binary = record.spec.task_id
        with self._lock:
            if task_binary in self._entries:
                return True
            size = self._estimate(record.spec)
            self._entries[task_binary] = {"size": size,
                                          "live": set(live_outputs)}
            self.bytes += size
        self._enforce_cap()
        return True

    def is_retained(self, task_binary: bytes) -> bool:
        with self._lock:
            return task_binary in self._entries

    def discard(self, task_binary: bytes) -> bool:
        """Drop the ledger entry WITHOUT touching pins (callers that
        still owe an unpin — terminal failure paths — follow up with one
        ``_unpin_args``)."""
        with self._lock:
            ent = self._entries.pop(task_binary, None)
            if ent is None:
                return False
            self.bytes -= ent["size"]
        return True

    def on_output_freed(self, task_binary: bytes, binary: bytes) -> str:
        """One of the task's return refs died. Returns ``"keep"`` while
        sibling outputs still anchor the record, ``"drop"`` when this was
        the last (caller pops the record and unpins its args), or
        ``"untracked"`` for non-lineage records."""
        with self._lock:
            ent = self._entries.get(task_binary)
            if ent is None:
                return "untracked"
            ent["live"].discard(binary)
            if ent["live"]:
                return "keep"
            self._entries.pop(task_binary, None)
            self.bytes -= ent["size"]
        return "drop"

    def _enforce_cap(self) -> None:
        cap = int(CONFIG.lineage_max_bytes)
        victims: List[Tuple[bytes, Optional[TaskRecord]]] = []
        with self._lock:
            scanned, max_scan = 0, len(self._entries)
            while self.bytes > cap and self._entries and scanned < max_scan:
                task_binary, ent = self._entries.popitem(last=False)
                scanned += 1
                record = self.worker._tasks.get(task_binary)
                if record is not None and not record.completed:
                    # replay in flight: not evictable right now — rotate
                    # to the back; a later retain() pass retries
                    self._entries[task_binary] = ent
                    continue
                self.bytes -= ent["size"]
                self.evictions += 1
                victims.append((task_binary, record))
        # pin release happens OUTSIDE the lock: unpinning cascades into
        # _free_owned -> on_output_freed of upstream records
        for task_binary, record in victims:
            self.worker._tasks.pop(task_binary, None)
            if record is not None:
                self.worker._unpin_args(record.spec)

    def add_listener(self, fn) -> None:
        """Subscribe ``fn(task_binary)`` to lineage resubmissions. Bound
        methods are held weakly — the subscriber's death IS the
        unsubscribe (the streaming shuffle registers per exchange and
        never cleans up explicitly)."""
        try:
            ref = weakref.WeakMethod(fn)
        except TypeError:
            ref = (lambda f: (lambda: f))(fn)  # plain callable: hold it
        with self._lock:
            self._listeners.append(ref)

    def notify_replay(self, task_binary: bytes) -> None:
        """Tell subscribers a task was just resubmitted from lineage.
        Runs on the recovery path — listener errors are swallowed, dead
        weak refs are pruned in passing."""
        with self._lock:
            refs = list(self._listeners)
        dead = []
        for r in refs:
            fn = r()
            if fn is None:
                dead.append(r)
                continue
            try:
                fn(task_binary)
            except Exception:
                pass
        if dead:
            with self._lock:
                self._listeners = [r for r in self._listeners
                                   if r not in dead]

    def task_hexes(self) -> set:
        with self._lock:
            return {tb.hex() for tb in self._entries}

    def summary(self) -> Dict:
        with self._lock:
            return {"records": len(self._entries), "bytes": self.bytes,
                    "reconstructions": self.reconstructions,
                    "evictions": self.evictions}


class WorkerConn:
    """A leased remote worker we push tasks to directly."""

    def __init__(self, lease_id: str, worker_id: str, addr: Dict, node_id: str,
                 agent_addr: Optional[Dict]):
        self.lease_id = lease_id
        self.worker_id = worker_id
        self.addr = addr
        self.node_id = node_id
        self.agent_addr = agent_addr  # where to return the lease (None = local)
        self.client: Optional[AsyncRpcClient] = None
        self.idle_since = 0.0
        self.dead = False
        self.inflight = 0  # tasks pushed and not yet replied (pipelining)
        # Monotonic dispatch timestamps of in-flight tasks (FIFO: the worker
        # executes and replies in push order). Used to detect a long-running
        # head-of-line task so new work is not pipelined behind it.
        self.dispatch_times: deque = deque()
        # Function names of the same in-flight tasks (parallel deque):
        # pipelining behind a head-of-line function the pool has never
        # observed completing would strand the queued task for an
        # unbounded time (a committed task cannot be stolen back).
        self.dispatch_fns: deque = deque()


class Worker:
    MODE_DRIVER = "driver"
    MODE_WORKER = "worker"

    def __init__(self):
        self.mode = self.MODE_DRIVER
        self.connected = False
        self.worker_id = WorkerID.from_random()
        self.job_id = JobID.from_random()
        self.node_id: str = ""
        self.session_dir: str = ""
        self.serialization_context = ser.SerializationContext()
        self.memory_store = MemoryStore()
        self.reference_counter = ReferenceCounter(self)
        self._put_counter = _Counter()
        self._task_counter = _Counter()
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self._loop_thread: Optional[threading.Thread] = None
        self.agent: Optional[AsyncRpcClient] = None
        self.head: Optional[AsyncRpcClient] = None
        self.direct_server = RpcServer("direct")
        self.direct_port = 0
        self.store: Optional[StoreClient] = None
        self.agent_tcp_addr: Optional[Dict] = None
        # borrowed-object plasma locations learned from owner replies
        # (hex-free: keyed by ObjectID bytes), consulted when pulling a
        # borrowed object whose meta we don't own
        self._borrowed_locations: Dict[bytes, List[Dict]] = {}
        # submitter state (loop-owned)
        self._lease_pools: Dict[Tuple, "_LeasePool"] = {}
        self._tasks: Dict[bytes, TaskRecord] = {}
        # replayable-lineage cap/accounting over _tasks
        self._lineage = LineageLedger(self)
        self._actor_states: Dict[bytes, "_ActorState"] = {}
        self._actor_sub_started = False
        # node_id -> {"incarnation", "reason", "time"}: death verdicts from
        # the GCS node channel; work targeting these nodes fails fast with
        # NodeDiedError instead of waiting out network deadlines
        self._dead_nodes: Dict[str, Dict] = {}
        # unpins queued by zero-copy-view finalizers: a GC-context
        # callback must never take _inbox_mu (the R1 destructor-deadlock
        # shape), so it only appends here (deque: lock-free under the
        # GIL) and the loop flushes
        self._pending_unpins: deque = deque()
        self._owner_conn_pool = ConnectionPool()
        # Multiplexed direct-call plane: ONE session per peer
        # process carries every actor/lease/owner channel as a stream;
        # same-node sessions attach the shm doorbell lane. Identity fns
        # are lazy — node_id/store land at registration.
        self._mux_pool = MuxPool(
            node_id_fn=lambda: self.node_id or None,
            store_dir_fn=lambda: getattr(self.store, "store_dir", None))
        # batched control RPCs: queued anonymous CreateActor
        # payloads (one CreateActorBatch frame per flush window) and the
        # LeaseItem routers for in-flight RequestWorkerLeaseBatch calls
        self._pending_creates: List[Dict] = []
        self._create_flush_armed = False
        self._create_inflight = 0
        self._lease_batches: Dict[Any, Any] = {}
        self._lease_batch_seq = 0
        self.current_task_info = threading.local()
        self.task_events: List[Dict] = []
        self.actor_instance = None  # set in actor workers
        self.log_prefix = ""
        # Coalesced main-thread → loop-thread doorbell: N submissions in one
        # burst become one loop wakeup (reference batches this boundary via
        # the Cython-held io_service post in core_worker.cc; pure-Python pays
        # ~1ms per run_coroutine_threadsafe under CPU contention without it).
        self._inbox: deque = deque()
        self._inbox_mu = threading.Lock()
        self._inbox_armed = False
        self._direct_addr_cache: Optional[Dict] = None
        # submission fast path: frozen spec templates keyed by
        # (function id, options hash) — a redefined function gets a new id,
        # so invalidation is inherent; clear-on-cap bounds growth
        self._spec_templates: Dict[Tuple, "SpecTemplate"] = {}
        # batched completion delivery (loop-owned): task replies landing in
        # one tick drain through one callback, with inline returns
        # coalesced into one memory-store put_batch
        self._completion_buf: List = []
        self._completions_armed = False
        self._resolve_sink: Optional[List] = None

    # ------------------------------------------------------------- lifecycle
    def connect(
        self,
        agent_unix_path: str,
        mode: str = MODE_DRIVER,
        job_id: Optional[JobID] = None,
    ) -> None:
        self.mode = mode
        if job_id:
            self.job_id = job_id
        # install BEFORE the loop thread and RPC clients exist so their
        # locks are created through the wrapping factories
        _sanitizer.maybe_install()
        self.loop = asyncio.new_event_loop()
        ready = threading.Event()

        def run_loop():
            asyncio.set_event_loop(self.loop)
            self.loop.call_soon(ready.set)
            self.loop.run_forever()

        self._loop_thread = threading.Thread(target=run_loop, daemon=True,
                                             name="raytpu-io")
        self._loop_thread.start()
        ready.wait()
        # Must be visible before RegisterClient makes this process leasable:
        # a task can be pushed (and executed) the moment registration lands,
        # and user code resolves global_worker at call time.
        global global_worker
        global_worker = self
        self._acall(self._async_connect(agent_unix_path))
        self.connected = True
        self._register_core_metrics()

    def _register_core_metrics(self) -> None:
        """Core-worker counters as CallbackGauges over plain ints: hot
        paths (submit/put) pay one integer add, the flusher reads at
        snapshot time (reference: metric_defs.cc tasks/owned-objects
        series). Driver-mode only — worker processes are counted by their
        node's agent."""
        if self.mode != self.MODE_DRIVER:
            return
        self._n_tasks_submitted = 0
        self._n_actor_calls = 0
        self._n_task_failures = 0
        self._n_puts = 0
        self._n_gets = 0
        try:
            from ray_tpu_torch.util.metrics import CallbackGauge

            for name, desc, fn in (
                ("ray_tpu_tasks_submitted_total",
                 "Normal tasks submitted by this driver.",
                 lambda: self._n_tasks_submitted),
                ("ray_tpu_actor_calls_total",
                 "Actor method calls submitted by this driver.",
                 lambda: self._n_actor_calls),
                ("ray_tpu_task_failures_total",
                 "Task failures observed by this driver.",
                 lambda: self._n_task_failures),
                ("ray_tpu_puts_total", "ray_tpu_torch.put calls.",
                 lambda: self._n_puts),
                ("ray_tpu_gets_total", "ray_tpu_torch.get calls.",
                 lambda: self._n_gets),
                # object ownership ledger: canonical names the
                # memory debugger / dashboards scrape (ray_tpu_owned_refs
                # REPLACES the old ray_tpu_owned_objects — same value,
                # one name)
                ("ray_tpu_owned_refs",
                 "Entries in this process's owned-object ledger.",
                 lambda: len(getattr(self.reference_counter, "_owned",
                                     ()) or ())),
                ("ray_tpu_borrowed_refs",
                 "Objects this process borrows from remote owners.",
                 lambda: len(getattr(self.reference_counter,
                                     "_is_borrower", ()) or ())),
                ("ray_tpu_lease_pools",
                 "Distinct scheduling categories with live lease pools.",
                 lambda: len(self._lease_pools)),
                # lineage reconstruction
                ("ray_tpu_lineage_reconstructions_total",
                 "Lost objects rebuilt by replaying their producing task.",
                 lambda: self._lineage.reconstructions),
                ("ray_tpu_lineage_bytes",
                 "Bytes of replayable task specs retained for lineage.",
                 lambda: self._lineage.bytes),
                ("ray_tpu_lineage_evictions_total",
                 "Lineage records evicted under lineage_max_bytes.",
                 lambda: self._lineage.evictions),
                # direct-call plane
                ("ray_tpu_mux_streams",
                 "Open streams across this driver's mux sessions.",
                 lambda: self._mux_pool.total_streams()),
                ("ray_tpu_mux_sessions",
                 "Live per-peer-process mux sessions.",
                 lambda: len(self._mux_pool._sessions)),
                ("ray_tpu_shm_calls_total",
                 "Frames this process sent over shm doorbell lanes.",
                 lambda: _shm_stats()["calls_out"]),
                ("ray_tpu_shm_fallback_oversize_total",
                 "Oversized frames that fell back to the TCP lane.",
                 lambda: _shm_stats()["fallback_oversize"]),
                ("ray_tpu_shm_fallback_ring_full_total",
                 "Ring-full frames that fell back to the TCP lane.",
                 lambda: _shm_stats()["fallback_ring_full"]),
            ):
                CallbackGauge(name, desc, fn)
        except Exception:
            pass  # metrics are best-effort

    async def _async_connect(self, agent_unix_path: str) -> None:
        trace = {} if os.environ.get("RAY_TPU_TORCH_BOOT_TRACE") else None
        t0 = time.monotonic()

        def mark(name):
            if trace is not None:
                trace[name] = round((time.monotonic() - t0) * 1000, 1)
                self._boot_trace = trace

        self.ready_event = asyncio.Event()
        self._register_direct_routes()
        self.direct_port = await self.direct_server.start_tcp("0.0.0.0", 0)
        mark("direct_tcp")
        self.agent = AsyncRpcClient()
        await self.agent.connect_unix(agent_unix_path)
        self.agent.set_push_handler(self._on_agent_push_sync)
        mark("agent_conn")
        reply = await self.agent.call(
            "RegisterClient",
            {
                "role": "worker" if self.mode == self.MODE_WORKER else "driver",
                "worker_id": self.worker_id.hex(),
                "pid": os.getpid(),
                "direct_addr": self.direct_addr(),
            },
            timeout=CONFIG.control_rpc_timeout_s,
        )
        mark("register")
        self.node_id = reply["node_id"]
        CONFIG.apply_cluster_config(reply.get("cluster_config", {}))
        self.store = make_store_client(reply["store_dir"])
        mark("store")
        self._head_addr = reply["head_addr"]
        self.head = AsyncRpcClient()
        # set while the head link is believed up; cleared by the watchdog
        # during an outage so queued control calls (head_call) know to
        # wait for the reconnect instead of spinning
        self._head_reconnected = asyncio.Event()
        self._head_boot_done = False
        if self.mode == self.MODE_WORKER and CONFIG.worker_lazy_head_connect:
            # boot-path trim: the head TCP setup + subscribe
            # round trips move OFF the time-to-leasable critical path —
            # most executor workers touch the head rarely (readiness now
            # rides the agent relay). Head-bound calls issued before the
            # background connect lands queue behind it via the outage
            # machinery (ConnectionLost -> wait _head_reconnected).
            self._spawn(self._connect_head_bg())
        else:
            await self._connect_head()
        # every process (driver AND executor workers) must survive a head
        # restart — workers hit the head for actor resolution, pubsub,
        # task events
        self._spawn(self._head_watchdog_loop())
        tcp_port = reply.get("tcp_port")
        if not tcp_port:
            info = await self.agent.call("GetNodeInfo", {},
                                         timeout=CONFIG.control_rpc_timeout_s)
            tcp_port = info["tcp_port"]
        self.agent_tcp_addr = {"host": node_ip(), "port": tcp_port}
        # flip BEFORE ready_event releases the executor: the first pushed
        # task may call user-facing API (ray_tpu_torch.get of a task arg ref)
        # immediately, and _require_worker checks this flag — setting it
        # on the main thread after _acall returned left a window where a
        # cold worker's first task failed with "init() must be called
        # first" (caught by the broadcast consumers)
        self.connected = True
        # arm the flight recorder AFTER the cluster config
        # landed so the head-broadcast sample rate applies; the ring file
        # lives under <session>/events/ so a kill -9 here is recoverable
        self.session_dir = (reply.get("session_dir")
                            or os.environ.get("RAY_TPU_TORCH_SESSION_DIR", ""))
        if self.session_dir:
            _events.configure(self.session_dir, self.mode)
        self._last_span_flush = time.monotonic()
        mark("ready")
        self.ready_event.set()

    async def _connect_head(self) -> None:
        await self.head.connect_tcp(self._head_addr["host"],
                                    self._head_addr["port"])
        self.head.set_push_handler(self._on_head_push)
        if self.mode == self.MODE_DRIVER:
            await self.head.call(
                "RegisterDriver",
                {"job_id": self.job_id.hex(), "entrypoint": " ".join(os.sys.argv)},
                timeout=CONFIG.control_rpc_timeout_s,
            )
            if os.environ.get("RAY_TPU_TORCH_LOG_TO_DRIVER", "1") != "0":
                # worker stdout/stderr stream here via the agents' log
                # monitors (log_monitor.py) -> "(worker-x) line" output
                await self.head.call("Subscribe",
                                     {"channels": ["logs:all"]},
                                     timeout=CONFIG.control_rpc_timeout_s)
        # every process (driver AND executor workers) watches node
        # membership: a `removed` verdict fails pending leases/calls/pulls
        # aimed at that node promptly — under a partition the sockets
        # never RST, so this event is the ONLY fast death signal
        await self.head.call("Subscribe", {"channels": ["node"]},
                             timeout=CONFIG.control_rpc_timeout_s)
        # a restarted head has an empty subscriber table: re-subscribe the
        # actor channel so restart/death/address events keep flowing
        if self._actor_sub_started:
            await self.head.call("Subscribe", {"channels": ["actor"]},
                                 timeout=CONFIG.control_rpc_timeout_s)
        self._head_boot_done = True
        self._head_reconnected.set()  # wake outage-queued control calls

    async def _connect_head_bg(self) -> None:
        """Deferred worker-mode head connect (worker_lazy_head_connect):
        retries until it lands; the watchdog takes over reconnects only
        after the first successful connect (``_head_boot_done``), so the
        two never race a double connect_tcp onto one client."""
        backoff = DecorrelatedJitterBackoff(base_s=0.1, cap_s=1.0)
        while True:
            try:
                await self._connect_head()
                return
            except asyncio.CancelledError:
                raise
            except Exception:
                if self.ready_event.is_set() and not self.connected:
                    return  # disconnected while still booting the link
                await asyncio.sleep(backoff.next_delay())

    async def _head_watchdog_loop(self) -> None:
        """Driver survives a head restart (GCS fault tolerance): ping, and
        on failure reconnect + re-register + resubscribe."""
        # connect() flips self.connected only after _async_connect (which
        # spawned us) returns — wait for that before monitoring, else the
        # loop below exits before the runtime is even up
        for _ in range(600):
            if self.connected:
                break
            await asyncio.sleep(0.1)
        while self.connected:
            period = (CONFIG.worker_head_watchdog_period_s
                      if self.mode == self.MODE_WORKER
                      else CONFIG.head_watchdog_period_s)
            await asyncio.sleep(period)
            # periodic task-event flush: observers (state API, dashboard)
            # must see this process's transitions without it having to
            # query (reference: TaskEventBuffer's periodic GCS flush,
            # task_event_buffer.h:206)
            try:
                self.flush_task_events()
            except Exception:
                pass
            try:
                await asyncio.wait_for(self.head.call("Ping", {}),
                                       timeout=CONFIG.head_ping_timeout_s)
                # a queued head_call may have cleared the flag on a
                # transient error the link already recovered from
                self._head_reconnected.set()
                continue
            except Exception:
                if not self.connected:
                    return
            if not self._head_boot_done:
                # the deferred boot connect (_connect_head_bg) still owns
                # the link — a concurrent reconnect here would stack a
                # second read loop onto the same client
                continue
            # outage begins: queued control calls park until reconnect
            self._head_reconnected.clear()
            # decorrelated jitter so a cluster's worth of drivers/workers
            # doesn't stampede the freshly restarted head in lockstep
            backoff = DecorrelatedJitterBackoff(base_s=0.2, cap_s=2.0)
            while self.connected:
                try:
                    await self.head.aclose()
                except Exception:
                    pass
                try:
                    await self._connect_head()
                    break
                except Exception:
                    await asyncio.sleep(backoff.next_delay())

    def disconnect(self) -> None:
        if not self.connected:
            return
        try:
            # queued batched creates must reach the head before the link
            # drops (a lost create would strand its handle PENDING)
            self._acall(self._drain_actor_creates(), timeout=5)
        except Exception:
            pass
        self.connected = False

        async def _close():
            await self.direct_server.close()
            # cancel AND await each client's read loop (aclose): a
            # cancelled-but-never-awaited task left on a stopping loop is
            # exactly the "Task was destroyed but it is pending!" warning
            for client in (self.agent, self.head):
                if client is not None:
                    await client.aclose()
            await self._owner_conn_pool.aclose_all()
            await self._mux_pool.aclose_all()

        try:
            self._acall(_close(), timeout=5)
        except Exception:
            pass
        if self.loop:
            def _stop():
                async def _drain():
                    # consume every cancellation before the loop dies so
                    # no task is destroyed while pending. Multi-round: a
                    # cancelled task's cleanup (close_soon, disconnect
                    # handlers) can SPAWN new tasks after the first
                    # snapshot — each round re-snapshots; bounded so one
                    # uncancellable straggler can't wedge disconnect.
                    me = asyncio.current_task(self.loop)
                    for _ in range(3):
                        pending = [t for t in asyncio.all_tasks(self.loop)
                                   if t is not me and not t.done()]
                        if not pending:
                            break
                        for task in pending:
                            task.cancel()
                        await asyncio.wait(pending, timeout=2)
                    self.loop.stop()

                hold_task(self.loop.create_task(_drain()), "disconnect-drain")

            self.loop.call_soon_threadsafe(_stop)
            thread = getattr(self, "_loop_thread", None)
            if thread is not None and thread is not threading.current_thread():
                thread.join(timeout=5)
        global global_worker
        if global_worker is self:
            global_worker = None

    def direct_addr(self) -> Dict:
        addr = self._direct_addr_cache
        if addr is None or addr["port"] != self.direct_port \
                or addr.get("node_id", "") != self.node_id:
            addr = {"host": node_ip(), "port": self.direct_port,
                    "worker_id": self.worker_id.hex()}
            if self.node_id:
                # lets a same-node caller select the shm lane without a
                # probe round trip (mux shm eligibility check)
                addr["node_id"] = self.node_id
            # raylint: disable=R13 -- idempotent memo: every writer
            # computes the same value from the same inputs and the dict
            # is never mutated after the GIL-atomic reference store, so
            # a racing rebuild wastes a dict, never corrupts one
            self._direct_addr_cache = addr
        return addr

    # ------------------------------------------------------------ loop utils
    def _acall(self, coro, timeout: Optional[float] = None):
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        return fut.result(timeout)

    async def _head_call_async(self, method: str, payload: Dict,
                               timeout: Optional[float] = None):
        """Outage-tolerant head-bound control call: on a lost head
        connection the call queues behind the watchdog's reconnect for up
        to ``gcs_outage_queue_s`` (instead of failing instantly on a head
        bounce), then fails fast with a typed
        :class:`~ray_tpu_torch.exceptions.HeadUnavailableError`. Server-side
        errors and slow-reply timeouts propagate unchanged — only a DOWN
        head queues. An explicit ``timeout`` bounds BOTH each RPC attempt
        and the total time queued.

        Delivery is at-least-once: when the head dies AFTER applying a
        mutation but before the reply, the retry re-executes it against
        the recovered head. Creates are deduped server-side by
        client-generated actor id; idempotent ops (KvPut/KvGet/KillActor)
        are safe by shape; but non-idempotent RESULTS (e.g. KvDel's
        deleted-key count) may reflect the retry, not the first
        delivery."""
        from ray_tpu_torch._private.protocol import ConnectionLost
        from ray_tpu_torch.exceptions import HeadUnavailableError

        budget = float(CONFIG.gcs_outage_queue_s)
        if timeout is not None:
            # an explicit per-call timeout also caps the total queueing:
            # `status` against a down head must answer in seconds, not
            # ride out the full outage budget
            budget = min(budget, float(timeout))
        deadline = time.monotonic() + budget
        rpc_timeout = timeout if timeout is not None \
            else CONFIG.control_rpc_timeout_s
        while True:
            try:
                return await self.head.call(method, payload,
                                            timeout=rpc_timeout)
            except (ConnectionLost, ConnectionError, OSError) as e:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self.connected:
                    raise HeadUnavailableError(
                        method=method, outage_s=budget) from e
                # the watchdog may not have noticed yet: mark the link
                # down ourselves, then wait for its reconnect signal
                self._head_reconnected.clear()
                try:
                    await asyncio.wait_for(
                        self._head_reconnected.wait(),
                        timeout=min(0.5, max(remaining, 0.05)))
                except asyncio.TimeoutError:
                    pass

    def head_call(self, method: str, payload: Dict,
                  timeout: Optional[float] = None):
        """Sync facade of :meth:`_head_call_async` (main-thread callers)."""
        return self._acall(self._head_call_async(method, payload,
                                                 timeout=timeout))

    def _loop_call(self, fn, *args):
        self.loop.call_soon_threadsafe(fn, *args)

    def _post(self, fn, *args) -> None:
        """Run fn(*args) on the loop thread, coalescing wakeups across a
        burst of submissions from the main thread."""
        with self._inbox_mu:
            self._inbox.append((fn, args))
            if self._inbox_armed:
                return
            self._inbox_armed = True
        try:
            self.loop.call_soon_threadsafe(self._drain_inbox)
        except RuntimeError:
            pass  # loop shut down

    def _drain_inbox(self) -> None:
        while True:
            with self._inbox_mu:
                if not self._inbox:
                    self._inbox_armed = False
                    return
                batch = list(self._inbox)
                self._inbox.clear()
            for fn, args in batch:
                try:
                    fn(*args)
                except Exception:
                    import logging
                    import traceback

                    logging.getLogger("ray_tpu_torch").error(
                        "inbox callback failed:\n%s", traceback.format_exc())

    def _spawn(self, coro):
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)

        def _log_failure(f):
            exc = f.exception() if not f.cancelled() else None
            if exc is not None:
                import logging
                import traceback

                logging.getLogger("ray_tpu_torch").error(
                    "background runtime coroutine failed: %s\n%s", exc,
                    "".join(traceback.format_exception(exc)))

        fut.add_done_callback(_log_failure)

    # --------------------------------------------------------- owner service
    def _register_direct_routes(self):
        r = self.direct_server.add_handler
        r("LocateObject", self._handle_locate_object)
        r("GetOwnedValue", self._handle_get_owned_value)
        r("AddBorrow", self._handle_add_borrow)
        r("RemoveBorrow", self._handle_remove_borrow)
        r("ObjectLocationAdded", self._handle_location_added)
        r("StreamingReturn", self._handle_streaming_return)
        r("GetObjectRefs", self._handle_get_object_refs)
        r("ReconstructObject", self._handle_reconstruct_object)
        r("Ping", self._handle_ping)
        r("ShmAttach", self._handle_shm_attach)
        r("ShmDetach", handle_shm_detach)
        self.direct_server.set_disconnect_handler(
            self._on_direct_disconnect)

    async def _handle_shm_attach(self, conn, p) -> Dict:
        """Same-node caller upgrading its session to the shm lane.
        Declines (cross-node, no arena, disabled) leave the
        session on TCP."""
        return await handle_shm_attach(
            self.direct_server, conn, p, self.node_id,
            getattr(self.store, "store_dir", None))

    async def _on_direct_disconnect(self, conn) -> None:
        demux = getattr(conn, "mux_demux", None)
        if demux is not None:
            conn.mux_demux = None
            demux.close()  # unmaps rings, closes doorbell fds

    async def _handle_streaming_return(self, conn, p) -> Dict:
        """One yielded item of a streaming-generator task (reference:
        core_worker ReportGeneratorItemReturns). The executor awaits this
        ack per item — backpressure for free."""
        task_binary = bytes.fromhex(p["task_id"])
        record = self._tasks.get(task_binary)
        if record is None or record.streaming_gen is None:
            return {"accepted": False}
        oid = ObjectID.for_task_return(TaskID(task_binary), p["index"])
        self.reference_counter.register_owned(
            oid, callsite=record.callsite,
            creator="task:" + record.spec.function_name,
            creator_id=record.spec.task_id.hex())
        self._resolve_return(oid, p["ret"])
        record.return_ids.append(oid)
        record.streaming_gen._push(ObjectRef(oid, self.direct_addr()))
        return {"accepted": True}

    async def _handle_ping(self, conn, p):
        return {"worker_id": self.worker_id.hex()}

    async def _handle_get_object_refs(self, conn, p) -> Dict:
        """Dump this process's ref tables. With ``ids`` the
        reply is the leak watchdog's targeted per-id verdict; without,
        the full provenance dump the memory debugger aggregates."""
        p = p or {}
        ids = p.get("ids")
        if ids is not None:
            binaries = []
            for h in ids:
                try:
                    binaries.append(bytes.fromhex(h))
                except ValueError:
                    continue
            return {"refs": self.reference_counter.ref_info(binaries)}
        out = self.reference_counter.dump(
            limit=int(p.get("limit", 10000)))
        # lineage annotations: per-object "is the producing
        # task's record retained" + the ledger totals the memory
        # debugger's lineage column renders
        retained = self._lineage.task_hexes()
        for row in out.get("owned", ()):
            row["lineage"] = row.get("creator_id", "") in retained
        out.update({"worker_id": self.worker_id.hex(), "pid": os.getpid(),
                    "mode": self.mode, "node_id": self.node_id,
                    "lineage": self._lineage.summary()})
        return out

    async def _handle_reconstruct_object(self, conn, p) -> Dict:
        """A borrower's pull failed and it asks us — the owner — to
        replay the producing chain (reference:
        object_recovery_manager.h borrower->owner recovery RPC). Nothing
        here blocks: a successful recovery is a resubmit, and the caller
        re-resolves the object once the replay seals it."""
        p = p or {}
        try:
            binary = bytes.fromhex(p["object_id"])
        except (KeyError, ValueError, TypeError):
            return {"status": "no_lineage", "reason": "malformed object id",
                    "chain": []}
        ref = ObjectRef(ObjectID(binary), self.direct_addr())
        chain: List[Dict] = []
        try:
            ok = self._recover_chain(ref, int(p.get("attempt", 1)), 0, chain)
        except ObjectLostError as e:
            return {"status": "no_lineage",
                    "reason": getattr(e, "reason", "") or str(e),
                    "chain": list(getattr(e, "chain", None) or chain)}
        if not ok:
            return {"status": "no_lineage",
                    "reason": "task opted out of lineage reconstruction "
                              "(max_retries=0) or retry budget exhausted",
                    "chain": chain}
        return {"status": "resubmitted", "chain": chain}

    async def _resolve_owned(self, binary: bytes, timeout: float) -> Optional[OwnedObjectMeta]:
        meta = self.reference_counter.get_owned_meta(binary)
        if meta is None:
            return None
        if meta.state == "pending":
            if meta.resolved_event is None:
                meta.resolved_event = asyncio.Event()
            try:
                await asyncio.wait_for(meta.resolved_event.wait(), timeout)
            except asyncio.TimeoutError:
                pass
        return meta

    async def _handle_locate_object(self, conn, p) -> Optional[Dict]:
        binary = bytes.fromhex(p["object_id"])
        meta = await self._resolve_owned(
            binary, timeout=CONFIG.owned_resolve_timeout_s)
        if meta is None:
            return None
        if meta.state == "inline":
            entry = self.memory_store.get(binary)
            if entry:
                return {"inline": entry[0], "is_exception": entry[1]}
        if meta.state == "plasma":
            return {"locations": meta.locations}
        return None

    async def _handle_get_owned_value(self, conn, p) -> Optional[Dict]:
        binary = bytes.fromhex(p["object_id"])
        block = p.get("block", True)
        meta = await self._resolve_owned(
            binary,
            timeout=CONFIG.owned_resolve_timeout_s if block else 0.01)
        if meta is None:
            return {"status": "unknown"}
        if meta.state == "inline" or meta.state == "error":
            entry = self.memory_store.get(binary)
            if entry:
                return {"status": "inline", "data": entry[0],
                        "is_exception": entry[1]}
        if meta.state == "plasma":
            return {"status": "plasma", "locations": meta.locations}
        if meta.state == "freed":
            return {"status": "freed"}
        return {"status": "pending"}

    async def _handle_add_borrow(self, conn, p):
        self.reference_counter.add_borrow(bytes.fromhex(p["object_id"]))

    async def _handle_remove_borrow(self, conn, p):
        self.reference_counter.remove_borrow(bytes.fromhex(p["object_id"]))

    async def _handle_location_added(self, conn, p):
        if not self.reference_counter.add_location(
                bytes.fromhex(p["object_id"]), p["addr"]):
            # freed before this notice landed: the pulling agent wakes
            # its readers before it tells the owner, so a reader that
            # drops the ref at once frees the object without this copy
            await self._free_copy(p["addr"], p["object_id"])

    def _on_agent_push_sync(self, method: str, payload):
        """Agent-connection push dispatch. LeaseItem routes INLINE in the
        read loop (set_push_handler contract): the per-entry grants of a
        RequestWorkerLeaseBatch stream on the same connection as the
        batch's closing reply, and an inline route guarantees every item
        is claimed before the awaiting batch call resumes and tears down
        its router. Everything else keeps the per-push task."""
        if method == "LeaseItem":
            cb = self._lease_batches.get((payload or {}).get("b"))
            if cb is not None:
                cb(payload)
            return None
        return self._on_agent_push(method, payload)

    async def _on_agent_push(self, method: str, payload):
        pass

    async def _on_head_push(self, method: str, payload):
        if method == "Pub":
            channel = payload.get("channel")
            if channel == "actor":
                self._on_actor_event(payload["message"])
            elif channel == "node":
                self._on_node_event(payload["message"])
            elif channel and channel.startswith("logs:"):
                msg = payload["message"]
                src = msg.get("src", "worker")
                for line in msg.get("lines") or \
                        ([msg["line"]] if msg.get("line") else []):
                    print(f"({src}) {line}")

    def _on_node_event(self, msg: Dict) -> None:
        """GCS node-channel event (loop thread). A `removed` verdict is
        the partition-tolerant fail-fast trigger: sockets to the dead
        node will never RST, so without this every pending lease, actor
        call, and pull targeting it would ride its own (up to 600 s)
        deadline."""
        event = msg.get("event")
        node_id = msg.get("node_id")
        if not node_id:
            return
        if event == "added":
            # a fresh incarnation rejoined under the same node_id: new
            # work may target it again
            self._dead_nodes.pop(node_id, None)
            return
        if event != "removed":
            return
        self._dead_nodes[node_id] = {
            "incarnation": msg.get("incarnation", 0),
            "reason": msg.get("reason", ""),
            "time": msg.get("time") or time.time(),
            # agent addr: lets lineage recovery match an object's known
            # locations (host/port dicts) against death verdicts
            "addr": dict(msg.get("addr") or {}),
        }
        addr = msg.get("addr") or {}
        if addr.get("host") is not None and addr.get("port") is not None:
            # spilled lease requests / owner RPCs in flight to that agent
            # fail now (close() fails their pending futures)
            self._owner_conn_pool.drop(addr["host"], addr["port"])
            self._mux_pool.drop(addr["host"], addr["port"])
        # every mux session to a process ON that node dies with it
        self._mux_pool.drop_node(node_id)
        for pool in list(self._lease_pools.values()):
            pool.on_node_removed(node_id)

    def node_death_error(self, node_id: str,
                         detail: str = "") -> Optional[NodeDiedError]:
        info = self._dead_nodes.get(node_id)
        if info is None:
            return None
        reason = info.get("reason", "")
        timeline = [(info.get("time", time.time()),
                     f"node removed: {reason}")]
        if detail:
            timeline.append((time.time(), detail))
        return NodeDiedError(node_id=node_id,
                             incarnation=info.get("incarnation", 0),
                             reason=reason, timeline=timeline)

    def _notify_owner_async(self, owner_addr: Dict, method: str, payload: Dict):
        if not owner_addr or not self.loop or not self.connected:
            return

        async def go():
            try:
                client = await self._owner_client(owner_addr)
                await client.push(method, payload)
            except Exception:
                pass

        try:
            self._spawn(go())
        except RuntimeError:
            pass

    async def _direct_stream(self, addr: Dict, label: str = "",
                             node_id: Optional[str] = None):
        """Open a direct-call channel to a peer process: a stream on the
        shared per-process mux session (— the connection is
        multiplexed, same-node peers ride the shm lane), or a dedicated
        AsyncRpcClient when the mux plane is disabled."""
        if CONFIG.direct_call_mux_enabled:
            return await self._mux_pool.stream(
                addr["host"], addr["port"], label=label,
                peer_node_id=node_id or addr.get("node_id"))
        client = AsyncRpcClient()
        await client.connect_tcp(addr["host"], addr["port"])
        client.start_idle_monitor(CONFIG.client_idle_deadline_s)
        return client

    async def _owner_client(self, addr: Dict):
        # shared race-guarded pool: concurrent spillback leases to one
        # agent used to both connect and leak the overwritten loser's
        # read loop — the bench-tail "second client in the connection
        # pool" destroyed-pending warning. With the mux plane enabled
        # the channel is the session's shared owner stream, so owner
        # callbacks and actor/lease traffic to one process share ONE
        # socket pair.
        if CONFIG.direct_call_mux_enabled:
            sess = await self._mux_pool.session(
                addr["host"], addr["port"],
                peer_node_id=addr.get("node_id"))
            return sess.shared_stream("owner")
        return await self._owner_conn_pool.get(addr["host"], addr["port"])

    # ------------------------------------------------------------------ put
    def put(self, value: Any) -> ObjectRef:
        self._n_puts = getattr(self, "_n_puts", 0) + 1
        object_id = ObjectID.from_put(self._put_counter.next(), self.worker_id)
        self.put_object(object_id, value)
        return ObjectRef(object_id, self.direct_addr())

    def _current_creator(self) -> Tuple[str, str]:
        """(creator tag, creating task id hex) for provenance: the task
        executing on this thread, else the driver itself."""
        info = self.current_task_info
        tid = getattr(info, "task_id", None)
        if tid is not None:
            name = getattr(info, "task_name", "") or ""
            return "task:" + name, tid.hex()
        return "driver", ""

    def put_object(self, object_id: ObjectID, value: Any) -> None:
        rec = _events.REC
        trace = rec.new_trace() if rec.enabled and rec.sample() else None
        t0 = time.time() if trace is not None else 0.0
        creator, creator_id = self._current_creator()
        callsite = _user_callsite()
        sobj = self._serialize_value(value)
        size = sobj.total_size()
        self.reference_counter.register_owned(
            object_id, callsite=callsite, creator=creator,
            creator_id=creator_id, size=size)
        if size <= CONFIG.inline_object_max_size_bytes:
            self.memory_store.put(object_id.binary(), sobj.to_bytes(), False)
            self.reference_counter.set_resolved(
                object_id.binary(), "inline", size=size)
        else:
            zero_copy = isinstance(sobj, ser.ZeroCopyArray)
            view, handle = self.store.create(object_id, size)
            used = sobj.write_into(view)
            self.store.seal(object_id, handle)
            # Fire-and-forget: the seal notification rides the agent socket
            # ahead of any later lease/pin request (frame order on one
            # connection preserves happens-before), so the blocking round
            # trip the old path paid per put is unnecessary. The owner addr
            # rides along so the leak watchdog can ask the owner
            # about any sealed object without a directory walk.
            self._post(self.agent.push_nowait,
                       "ObjectSealed", {"object_id": object_id.hex(),
                                        "size": used,
                                        "zero_copy": zero_copy,
                                        "owner": self.direct_addr(),
                                        "callsite": callsite,
                                        "task": creator_id})
            self.memory_store.put(object_id.binary(), b"", IN_PLASMA)
            self.reference_counter.set_resolved(
                object_id.binary(), "plasma", [self.agent_tcp_addr],
                size=used)
        if trace is not None:
            rec.record("put", "object", t0, time.time() - t0,
                       trace[0], trace[1], 0,
                       {"obj": object_id.hex()[:16], "bytes": size})

    def _serialize_value(self, value: Any):
        """Returns a SerializedObject, or a ZeroCopyArray for bare
        contiguous arrays (duck-compatible; no pickle pass)."""
        ctx = ser.get_reducer_context()
        ctx.collected_refs = []
        try:
            return self.serialization_context.serialize(value)
        finally:
            ctx.collected_refs = None

    # ------------------------------------------------------------------ get
    def get(self, refs: List[ObjectRef], timeout: Optional[float] = None) -> List[Any]:
        self._n_gets = getattr(self, "_n_gets", 0) + 1
        rec = _events.REC
        tc = None
        if rec.enabled:
            # join the ambient trace (a sampled task calling get, or a
            # trace_parent scope) so the agent-side pull slices stitch
            # under the caller; else roll the root dice
            amb = _events.parent_ctx() or _events.current_ctx()
            if amb is not None:
                tc = (amb[0], rec.next_id(), amb[1])
            elif rec.sample():
                t, span = rec.new_trace()
                tc = (t, span, 0)
        t0 = time.time() if tc is not None else 0.0
        deadline = None if timeout is None else time.monotonic() + timeout
        self._batch_resolve_borrows(refs)
        self._prefetch_plasma(refs, tc=tc)
        out: List[Any] = [None] * len(refs)
        try:
            for i, ref in enumerate(refs):
                remaining = None
                if deadline is not None:
                    remaining = max(0.0, deadline - time.monotonic())
                out[i] = self._get_one(ref, remaining, tc=tc)
        finally:
            if tc is not None:
                rec.record("get", "object", t0, time.time() - t0,
                           tc[0], tc[1], tc[2], {"refs": len(refs)})
        return out

    def _batch_resolve_borrows(self, refs: List[ObjectRef]) -> None:
        """Resolve every still-unresolved BORROWED ref in one concurrent
        owner gather, so their plasma pulls can all start in the same
        WaitObjects window. The serial path below paid one owner round
        trip per ref — a shuffle reducer pulling M shards
        stalled M round trips before its first byte moved. Best-effort:
        any ref this pass skips (pending producer, owner hiccup) is
        resolved — and its errors raised — by the per-ref path."""
        need: List[ObjectRef] = []
        seen = set()
        for ref in refs:
            b = ref.binary()
            if b in seen:
                continue
            seen.add(b)
            if self.memory_store.get(b) is not None:
                continue
            if self.reference_counter.get_owned_meta(b) is not None:
                continue
            if ref.owner_addr():
                need.append(ref)
        if len(need) < 2:
            return  # serial path is one round trip anyway

        async def _one(ref: ObjectRef):
            try:
                client = await self._owner_client(ref.owner_addr())
                # block:False — resolve what is resolvable NOW. Blocking
                # here would serialize every pull-start behind the
                # SLOWEST producer (a reducer admitted mid-map-phase
                # would move zero bytes until the last map sealed);
                # still-pending refs fall to the per-ref path, which
                # blocks per object and pulls each as it is produced.
                reply = await client.call(
                    "GetOwnedValue",
                    {"object_id": ref.hex(), "block": False},
                    timeout=CONFIG.borrow_resolve_timeout_s,
                )
            except Exception:
                return
            self._cache_owner_reply(ref, reply)

        async def _all():
            await asyncio.gather(*(_one(r) for r in need))

        try:
            self._acall(_all(), timeout=CONFIG.borrow_resolve_timeout_s + 5)
        except Exception:
            pass

    def _prefetch_plasma(self, refs: List[ObjectRef],
                         min_need: int = 2, tc=None) -> None:
        """One WaitObjects frame covering every plasma-backed ref not yet
        local, so the agent STARTS all the pulls concurrently. Without
        this, the per-ref loop below paid one sequential cross-node pull
        latency per ref (N remote args -> N round trips); with it, N refs
        cost ~1 pull latency. num_returns=0 makes it pure initiation — it
        never blocks, so a lost/evicted ref costs exactly the serial
        path's verdict time, not a doubled one; the started pulls survive
        waiter-less stretches via the orphan grace window while the
        per-ref loop (full timeout/lost/recovery handling) catches up."""
        need: Dict[str, ObjectRef] = {}
        for ref in refs:
            hex_id = ref.hex()
            if hex_id in need:
                continue
            entry = self.memory_store.get(ref.binary())
            meta = self.reference_counter.get_owned_meta(ref.binary())
            in_plasma = (entry is not None and entry[1] == IN_PLASMA) or (
                meta is not None and meta.state == "plasma")
            if not in_plasma or self.store.contains(ref.id()):
                continue
            need[hex_id] = ref
        if len(need) < min_need:
            return  # the serial path's own WaitObjects is one call anyway
        try:
            # bounded: a stalled agent loop must surface as the per-ref
            # path's GetTimeoutError, not hang the prefetch forever
            self._acall(self.agent.call("WaitObjects", {
                "ids": list(need),
                "owners": {h: r.owner_addr() for h, r in need.items()},
                "num_returns": 0,
                "timeout_ms": 0,
                "tc": [tc[0], tc[1]] if tc is not None else None,
            }), timeout=5)
        except Exception:
            pass

    def _get_one(self, ref: ObjectRef, timeout: Optional[float],
                 tc=None) -> Any:
        binary = ref.binary()
        deadline = None if timeout is None else time.monotonic() + timeout
        attempt = 0
        while True:
            entry = self.memory_store.get(binary)
            if entry is None:
                owned = self.reference_counter.get_owned_meta(binary)
                if owned is not None:
                    left = self._time_left(deadline)
                    if left is not None and left <= 0:
                        raise GetTimeoutError(f"get timed out on {ref.hex()}")
                    ready, _ = self.memory_store.wait(
                        [binary], 1, left if left is not None else 1e9
                    )
                    if not ready:
                        raise GetTimeoutError(f"get timed out on {ref.hex()}")
                    continue
                # Borrowed object: resolve via owner.
                entry = self._resolve_borrowed(ref, deadline)
            data, flags = entry
            if flags == IN_PLASMA:
                value = self._get_from_plasma(ref, deadline, tc=tc)
                if value is _LOST:
                    attempt += 1
                    if not self._recover_lost_object(ref, attempt, tc=tc):
                        raise ObjectLostError(ref.hex())
                    continue
                result = value
            else:
                result = self.serialization_context.deserialize(memoryview(data))
            if flags == EXC or isinstance(result, (RayTaskError, RayActorError,
                                                   TaskCancelledError,
                                                   WorkerCrashedError)):
                if isinstance(result, RayTaskError) and result.cause is not None:
                    raise result.cause
                if isinstance(result, Exception):
                    raise result
            return result

    @staticmethod
    def _time_left(deadline) -> Optional[float]:
        return None if deadline is None else deadline - time.monotonic()

    def _cache_owner_reply(self, ref: ObjectRef, reply) -> Optional[str]:
        """Decode one GetOwnedValue reply and cache what it reveals
        (inline value / plasma marker + locations) in the local stores.
        The ONE place the owner-reply contract is interpreted — shared
        by the serial borrow resolver, the batched gather, and the
        wait() probe. Returns the reply's status (None if no reply)."""
        status = reply.get("status") if reply else None
        if status == "inline":
            flags = EXC if reply.get("is_exception") else VAL
            self.memory_store.put(ref.binary(), reply["data"], flags)
        elif status == "plasma":
            self.memory_store.put(ref.binary(), b"", IN_PLASMA)
            self._borrowed_locations[ref.binary()] = \
                reply.get("locations", [])
        return status

    def _resolve_borrowed(self, ref: ObjectRef, deadline) -> Tuple[bytes, int]:
        owner = ref.owner_addr()
        if not owner:
            raise ObjectLostError(ref.hex(), "has no owner information")
        while True:
            left = self._time_left(deadline)
            if left is not None and left <= 0:
                raise GetTimeoutError(f"get timed out on {ref.hex()}")

            async def ask():
                client = await self._owner_client(owner)
                return await client.call(
                    "GetOwnedValue", {"object_id": ref.hex(), "block": True},
                    timeout=CONFIG.borrow_resolve_timeout_s,
                )

            try:
                reply = self._acall(
                    ask(), timeout=CONFIG.borrow_resolve_timeout_s + 5)
            except Exception as e:
                raise ObjectLostError(ref.hex(), f"owner unreachable ({e})")
            status = self._cache_owner_reply(ref, reply) or "unknown"
            if status == "inline":
                flags = EXC if reply.get("is_exception") else VAL
                return reply["data"], flags
            if status == "plasma":
                return b"", IN_PLASMA
            if status == "freed":
                raise ObjectLostError(ref.hex(), "was freed by its owner")
            if status == "unknown":
                raise ObjectLostError(ref.hex(), "unknown to its owner")
            # pending: loop again

    def _get_from_plasma(self, ref: ObjectRef, deadline, tc=None):
        hex_id = ref.hex()
        view = self.store.get_view(ref.id())
        if view is None:
            meta = self.reference_counter.get_owned_meta(ref.binary())
            locations = (meta.locations if meta
                         else self._borrowed_locations.get(ref.binary(), []))
            left = self._time_left(deadline)
            timeout_ms = None if left is None else int(left * 1000)
            reply = self._acall(
                # raylint: disable=R6 -- long-poll by design: get() with no
                # deadline blocks until the object is produced; the server
                # bounds its own wait via timeout_ms and orphaned pulls are
                # reaped by the agent's object_pull_orphan_grace_s sweep
                self.agent.call(
                    "WaitObjects",
                    {
                        "ids": [hex_id],
                        "owners": {hex_id: ref.owner_addr()},
                        "locations": {hex_id: locations},
                        "num_returns": 1,
                        "timeout_ms": timeout_ms,
                        "tc": [tc[0], tc[1]] if tc is not None else None,
                    },
                )
            )
            if hex_id not in reply.get("ready", []):
                if left is not None and self._time_left(deadline) <= 0:
                    raise GetTimeoutError(f"get timed out on {hex_id}")
                return _LOST
            view = self.store.get_view(ref.id())
            if view is None:
                return _LOST
        result = self.serialization_context.deserialize(view)
        if ser.is_zero_copy(view):
            self._pin_escaping_view(hex_id, result)
        return result

    def _pin_escaping_view(self, hex_id: str, result) -> None:
        """A zero-copy array aliasing the store mmap is escaping to user
        code: pin the backing object for exactly the array's lifetime so
        eviction/spill can never reclaim a segment a live view still
        reads (the explicit-pin half of the R9 view-lifetime contract).
        Fire-and-forget pushes — frame order on the agent socket keeps
        pin-before-unpin, and a lost pin only weakens eviction ordering,
        never correctness (the mmap itself outlives the unlink).

        The finalizer runs in GC context, where taking _inbox_mu could
        deadlock its own thread (raylint R1, the MemoryStore shape): it
        only appends to a deque and pokes the loop directly."""
        import weakref

        try:
            self._post(self.agent.push_nowait,
                       "PinObject", {"object_id": hex_id})
        except Exception:
            return

        def _unpin(worker=self, hex_id=hex_id):
            worker._pending_unpins.append(hex_id)
            try:
                # call_soon_threadsafe takes no project lock — safe from
                # a destructor; if the loop is gone the pin dies with it
                worker.loop.call_soon_threadsafe(worker._flush_unpins)
            except Exception:
                pass

        try:
            weakref.finalize(result, _unpin)
        except TypeError:
            pass  # non-weakrefable result: the pin rides out the process

    def _flush_unpins(self) -> None:
        """Loop-thread drain of finalizer-queued unpins."""
        while self._pending_unpins:
            try:
                hex_id = self._pending_unpins.popleft()
            except IndexError:
                return
            try:
                self.agent.push_nowait("UnpinObject",
                                       {"object_id": hex_id})
            except Exception:
                pass

    def recover_task_returns(self, ref: ObjectRef) -> bool:
        """Lineage re-execution of the task that produced ``ref`` (every
        return is reset and the task resubmitted once under the SAME task
        id, so all return object ids stay stable). Thin wrapper over the
        general chain machinery kept for callers that want a bool, never
        an exception (the streaming shuffle's fresh-dispatch fallback)."""
        try:
            return self._recover_chain(ref, 1, 0, [])
        except ObjectLostError:
            return False

    def _try_recover(self, ref: ObjectRef, attempt: int) -> bool:
        """Lineage reconstruction of one owned object (reference:
        src/ray/core_worker/object_recovery_manager.h). Propagates
        :class:`ObjectReconstructionFailedError` when the lineage path
        was taken and is truly exhausted; returns False when the task
        opted out (max_retries=0) or the retry budget is spent."""
        return self._recover_chain(ref, attempt, 0, [])

    def _location_dead(self, loc: Optional[Dict]) -> bool:
        """Is this object location (an agent host/port addr) on a node
        the GCS has declared dead? Unknown locations count as live — the
        pull path is the authority for those; this only pre-triggers
        chain replay for copies we KNOW died."""
        if not loc:
            return True
        for info in self._dead_nodes.values():
            addr = info.get("addr") or {}
            if addr and addr.get("host") == loc.get("host") \
                    and addr.get("port") == loc.get("port"):
                return True
        return False

    def _recover_chain(self, ref: ObjectRef, attempt: int, depth: int,
                       chain: List[Dict]) -> bool:
        """Resubmit the task that created ``ref``, first recursively
        replaying any owned plasma ARGUMENT whose every known copy died
        with its node (chained replay). ``chain`` accumulates
        the replayed hops (outermost first) and rides the typed error so
        a failed reconstruction shows how far it got. Arguments borrowed
        from other owners recover lazily instead: the executor's pull
        fails and asks THAT owner via ReconstructObject."""
        binary = ref.binary()
        task_binary = ref.id().task_id().binary()
        hex_id = ref.hex()
        depth_cap = int(CONFIG.lineage_max_reconstruction_depth)
        if depth >= depth_cap:
            chain.append({"object_id": hex_id, "task": task_binary.hex(),
                          "why": "depth cap"})
            raise ObjectReconstructionFailedError(
                hex_id,
                f"lineage chain exceeds lineage_max_reconstruction_depth="
                f"{depth_cap}", chain)
        record = self._tasks.get(task_binary)
        if record is None:
            meta = self.reference_counter.get_owned_meta(binary)
            creator = meta.creator if meta is not None else ""
            if ref.id().is_put():
                why = "created by put(), no task lineage"
            elif creator.startswith("actor:"):
                why = "actor task result (actor state is not replayable)"
            elif creator.startswith("task:"):
                why = ("lineage record evicted (lineage_max_bytes) or "
                       "already released")
            else:
                return False  # not ours / no provenance: plain ObjectLostError
            chain.append({"object_id": hex_id, "task": task_binary.hex(),
                          "why": why})
            raise ObjectReconstructionFailedError(hex_id, why, chain)
        spec = record.spec
        if spec.task_type != NORMAL_TASK:
            why = "actor task result (actor state is not replayable)"
            chain.append({"object_id": hex_id, "task": task_binary.hex(),
                          "why": why})
            raise ObjectReconstructionFailedError(hex_id, why, chain)
        if spec.max_retries <= 0 or attempt > spec.max_retries:
            return False  # max_retries=0 opts out of lineage reconstruction
        attempts_cap = int(CONFIG.lineage_max_reconstruction_attempts)
        if record.reconstructions >= attempts_cap:
            why = (f"lineage_max_reconstruction_attempts={attempts_cap} "
                   f"exhausted")
            chain.append({"object_id": hex_id, "task": task_binary.hex(),
                          "why": why})
            raise ObjectReconstructionFailedError(hex_id, why, chain)
        if not record.completed:
            return True  # a re-execution is already in flight: just re-pull
        chain.append({"object_id": hex_id, "task": task_binary.hex(),
                      "why": "replayed"})
        # Chain step: an argument this process owns whose every known
        # plasma copy sits on a dead node must be replayed FIRST — the
        # resubmitted task's executor would otherwise stall pulling it.
        for entry in list(spec.args) + list(spec.kwargs.values()):
            if entry[0] != "r":
                continue
            arg_binary = entry[1]
            arg_meta = self.reference_counter.get_owned_meta(arg_binary)
            if arg_meta is None or arg_meta.state != "plasma":
                continue
            if any(not self._location_dead(loc)
                   for loc in arg_meta.locations):
                continue
            arg_ref = ObjectRef(ObjectID(arg_binary), self.direct_addr())
            self._recover_chain(arg_ref, 1, depth + 1, chain)
        record.reconstructions += 1
        self._lineage.reconstructions += 1
        # reset EVERY return, not just ref: sibling returns of a
        # multi-return task point at the same dead copy, and the replay
        # regenerates them all under the original ids. Only KNOWN-dead
        # locations are forgotten, though — a replica pulled to a
        # surviving node (a reducer's copy of a map shard, say) is real
        # bytes the final free must still reach, and wiping its location
        # here would orphan them in that node's store. The pending state
        # + dropped memory entry are what make get() wait for the replay
        # seal, so keeping an unproven location is safe either way.
        for oid in record.return_ids:
            meta = self.reference_counter.get_owned_meta(oid.binary())
            if meta:
                meta.state = "pending"
                meta.locations = [loc for loc in meta.locations
                                  if not self._location_dead(loc)]
            self.memory_store.delete(oid.binary())
        # the record finished once already; reopen it or the reconstruction
        # attempt's reply would be dropped as a stale late reply
        record.completed = False
        self._post(self._submit_to_pool_sync, record)
        self._lineage.notify_replay(task_binary)
        return True

    def _reconstruct_borrowed(self, ref: ObjectRef, attempt: int) -> bool:
        """Borrower-side recovery: ask the object's OWNER to replay its
        lineage, then forget the stale location hints so the next pull
        loop re-resolves fresh ones once the replay seals."""
        owner = ref.owner_addr()
        if not owner:
            return False
        if attempt > int(CONFIG.lineage_max_reconstruction_attempts):
            raise ObjectReconstructionFailedError(
                ref.hex(),
                f"lineage_max_reconstruction_attempts="
                f"{int(CONFIG.lineage_max_reconstruction_attempts)} "
                f"exhausted by this borrower")

        async def ask():
            client = await self._owner_client(owner)
            return await client.call(
                "ReconstructObject",
                {"object_id": ref.hex(), "attempt": attempt},
                timeout=CONFIG.control_rpc_timeout_s)

        try:
            reply = self._acall(ask(),
                                timeout=CONFIG.control_rpc_timeout_s + 5)
        except Exception as e:
            # a dead owner holds the only lineage record — nothing can
            # rebuild this object (the put()-with-dead-owner
            # contract covers task returns of dead drivers identically)
            raise ObjectReconstructionFailedError(
                ref.hex(), f"owner unreachable for reconstruction ({e})")
        status = (reply or {}).get("status")
        if status == "resubmitted":
            self.memory_store.delete(ref.binary())
            self._borrowed_locations.pop(ref.binary(), None)
            return True
        if status == "no_lineage":
            raise ObjectReconstructionFailedError(
                ref.hex(), reply.get("reason") or "owner holds no lineage",
                reply.get("chain") or [])
        return False

    def _recover_lost_object(self, ref: ObjectRef, attempt: int,
                             tc=None) -> bool:
        """A pull came back lost: owned refs replay their producing chain
        locally, borrowed refs ask the owner. True = a replay
        is in flight, re-pull; False = the object never opted into
        lineage (plain ObjectLostError at the caller); raises the typed
        error when the lineage path is exhausted or absent."""
        t0 = time.time()
        owned = self.reference_counter.get_owned_meta(ref.binary()) is not None
        outcome = "failed"
        try:
            if owned:
                ok = self._recover_chain(ref, attempt, 0, [])
            else:
                ok = self._reconstruct_borrowed(ref, attempt)
            outcome = "resubmitted" if ok else "opted_out"
            return ok
        finally:
            rec = _events.REC
            if rec.enabled and tc is not None:
                # nested under the triggering get's span
                rec.record("reconstruct::" + ref.hex()[:12], "object", t0,
                           max(0.0, time.time() - t0), tc[0], rec.next_id(),
                           tc[1], {"obj": ref.hex()[:16],
                                   "owned": owned, "outcome": outcome,
                                   "attempt": attempt})

    # ----------------------------------------------------------------- wait
    def wait(self, refs: List[ObjectRef], num_returns: int,
             timeout: Optional[float]) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        deadline = None if timeout is None else time.monotonic() + timeout
        # Borrowed refs need an owner RPC to probe; rate-limit those probes so
        # the poll loop doesn't hammer the owner (cheap local checks every
        # iteration, remote probes at most every 50ms per ref).
        last_probe: Dict[bytes, float] = {}
        while True:
            ready, not_ready = [], []
            for ref in refs:
                if self._is_ready(ref, last_probe):
                    ready.append(ref)
                else:
                    not_ready.append(ref)
            if len(ready) >= num_returns or (
                deadline is not None and time.monotonic() >= deadline
            ):
                chosen = ready[:num_returns]
                rest = [r for r in refs if r not in set(chosen)]
                return chosen, rest
            time.sleep(CONFIG.wait_poll_interval_s)

    def _is_ready(self, ref: ObjectRef,
                  last_probe: Optional[Dict[bytes, float]] = None) -> bool:
        entry = self.memory_store.get(ref.binary())
        if entry is not None:
            return True
        if self.store and self.store.contains(ref.id()):
            return True
        owned = self.reference_counter.get_owned_meta(ref.binary())
        if owned is not None:
            return owned.state in ("inline", "plasma", "error")
        # Borrowed: one cheap non-blocking probe of the owner.
        owner = ref.owner_addr()
        if not owner:
            return False
        if last_probe is not None:
            now = time.monotonic()
            if now - last_probe.get(ref.binary(), 0.0) < 0.05:
                return False
            last_probe[ref.binary()] = now

        async def probe():
            try:
                client = await self._owner_client(owner)
                return await client.call(
                    "GetOwnedValue", {"object_id": ref.hex(), "block": False},
                    timeout=CONFIG.actor_probe_timeout_s,
                )
            except Exception:
                return None

        try:
            reply = self._acall(probe(),
                                timeout=CONFIG.actor_probe_timeout_s + 1)
        except Exception:
            return False
        if not reply:
            return False
        return self._cache_owner_reply(ref, reply) in ("inline", "plasma")

    # ------------------------------------------------------------ free/kill
    def free(self, refs: List[ObjectRef]) -> None:
        for ref in refs:
            self._free_owned(ref.binary())

    async def _free_copy(self, loc: Dict, hex_id: str) -> None:
        """Free one node's copy of an object (best effort)."""
        try:
            if loc == self.agent_tcp_addr:
                await self.agent.call(
                    "FreeObjects", {"ids": [hex_id]},
                    timeout=CONFIG.control_rpc_timeout_s)
            else:
                client = await self._owner_client(loc)
                await client.call(
                    "FreeObjects", {"ids": [hex_id]},
                    timeout=CONFIG.control_rpc_timeout_s)
        except Exception:
            pass

    def _free_owned(self, binary: bytes) -> None:
        meta = self.reference_counter.get_owned_meta(binary)
        if meta is None:
            return
        state, locations = self.reference_counter.mark_freed(meta)
        self.memory_store.delete(binary)
        hex_id = ObjectID(binary).hex()
        if state == "plasma":
            async def free_remote():
                for loc in locations:
                    await self._free_copy(loc, hex_id)

            if self.connected:
                self._spawn(free_remote())
        self.reference_counter.drop_owned(binary)
        task_binary = ObjectID(binary).task_id().binary()
        record = self._tasks.get(task_binary)
        if record is None:
            return
        # a live streaming task's record must outlive early freed yields —
        # it routes the still-arriving StreamingReturn items
        if record.streaming_gen is not None and not record.completed:
            return
        verdict = self._lineage.on_output_freed(task_binary, binary)
        if verdict == "keep":
            return  # sibling returns still referenced anchor the lineage
        self._tasks.pop(task_binary, None)
        if verdict == "drop":
            # the record's LAST live output died: release its arg pins,
            # which may cascade-free (and cascade-release) upstream lineage
            self._unpin_args(record.spec)

    # =================================================================== tasks
    def _trace_for_submit(self):
        """Trace context for a new submission: join the ambient
        parent trace — an orchestration layer's trace_parent() override,
        or the trace of the sampled task currently executing on this
        thread — else roll the root sampling dice. Returns
        (trace_id, span_id, parent_span_id) or None; the first two ride
        the spec wire to the executor, the third parents the root span
        recorded at completion."""
        rec = _events.REC
        if not rec.enabled:
            return None
        parent = _events.parent_ctx() or _events.current_ctx()
        if parent is not None:
            return (parent[0], rec.next_id(), parent[1])
        if rec.sample():
            t, span = rec.new_trace()
            return (t, span, 0)
        return None

    def _task_template(
        self,
        function,
        num_returns: int,
        resources: Optional[Dict[str, float]],
        max_retries: int,
        retry_exceptions: bool,
        scheduling_strategy,
        placement_group,
        placement_group_bundle_index: int,
        runtime_env: Optional[Dict],
        name: str,
    ) -> SpecTemplate:
        """Frozen spec template for one (function, options) signature.
        The cache key leads with the function id — a
        redefined function serializes to a different blob and hence a
        different id, so a stale template can never serve the new body."""
        from ray_tpu_torch._private.function_table import function_descriptor
        from ray_tpu_torch._private.task_spec import runtime_env_key

        fid, blob, fname = function_descriptor(function, self)
        key = (
            fid, num_returns, max_retries, retry_exceptions, name,
            None if not resources else tuple(sorted(resources.items())),
            None if scheduling_strategy is None else repr(scheduling_strategy),
            None if placement_group is None else
            (placement_group.id_hex, placement_group_bundle_index),
            runtime_env_key(runtime_env),
        )
        tpl = self._spec_templates.get(key)
        if tpl is not None:
            return tpl
        from ray_tpu_torch._private.resources import ResourceSet

        res = dict(resources or {})
        res.setdefault("CPU", 1.0)
        pg = None
        if placement_group is not None:
            pg = [placement_group.id_hex, max(placement_group_bundle_index, 0)]
        tpl = SpecTemplate(
            job_id=self.job_id.binary(),
            task_type=NORMAL_TASK,
            function_id=fid,
            function_blob=blob,
            function_name=name or fname,
            num_returns=num_returns,
            resources=ResourceSet(res).to_wire(),
            owner_addr=self.direct_addr(),
            max_retries=max_retries,
            retry_exceptions=retry_exceptions,
            scheduling_strategy=_strategy_wire(scheduling_strategy),
            placement_group_id=(pg[0] if pg else None),
            placement_group_bundle_index=(pg[1] if pg else -1),
            runtime_env=runtime_env,
        )
        if len(self._spec_templates) >= CONFIG.spec_template_cache_max:
            self._spec_templates.clear()  # clear-on-cap, like the callsite cache
        self._spec_templates[key] = tpl
        return tpl

    def submit_task(
        self,
        function,
        args: tuple,
        kwargs: dict,
        num_returns: int = 1,
        resources: Optional[Dict[str, float]] = None,
        max_retries: int = -1,
        retry_exceptions: bool = False,
        scheduling_strategy=None,
        placement_group=None,
        placement_group_bundle_index: int = -1,
        runtime_env: Optional[Dict] = None,
        name: str = "",
    ) -> List[ObjectRef]:
        self._n_tasks_submitted = getattr(self, "_n_tasks_submitted", 0) + 1
        if max_retries < 0:
            max_retries = CONFIG.task_max_retries_default
        task_id = TaskID.from_random()
        wire_args = self._build_args(args) if args else []
        wire_kwargs = ({k: v for k, v in
                        zip(kwargs.keys(),
                            self._build_args(tuple(kwargs.values())))}
                       if kwargs else {})
        if CONFIG.submit_fastpath_enabled:
            tpl = self._task_template(
                function, num_returns, resources, max_retries,
                retry_exceptions, scheduling_strategy, placement_group,
                placement_group_bundle_index, runtime_env, name)
            spec = tpl.instantiate(
                task_id.binary(), wire_args, wire_kwargs,
                trace_ctx=self._trace_for_submit(),
                # stamped at FIRST submission and replayed verbatim, so a
                # lineage re-execution seeds the task body's RNG
                # identically and reproduces byte-identical returns
                replay_seed=_replay_seed(task_id.binary()))
        else:
            spec = self._build_task_spec_slow(
                function, task_id, wire_args, wire_kwargs, num_returns,
                resources, max_retries, retry_exceptions,
                scheduling_strategy, placement_group,
                placement_group_bundle_index, runtime_env, name)
        return self._finish_submit(spec, task_id, "task:",
                                   self._submit_to_pool_sync)

    def _build_task_spec_slow(
            self, function, task_id, wire_args, wire_kwargs, num_returns,
            resources, max_retries, retry_exceptions, scheduling_strategy,
            placement_group, placement_group_bundle_index, runtime_env,
            name) -> TaskSpec:
        """Template-free spec construction — the pre-18 per-call path,
        kept live behind ``submit_fastpath_enabled=0`` (the ray_perf
        ``--ab`` baseline arm)."""
        from ray_tpu_torch._private.function_table import function_descriptor
        from ray_tpu_torch._private.resources import ResourceSet

        fid, blob, fname = function_descriptor(function, self)
        resources = dict(resources or {})
        resources.setdefault("CPU", 1.0)
        pg = None
        if placement_group is not None:
            pg = [placement_group.id_hex, max(placement_group_bundle_index, 0)]
        return TaskSpec(
            task_id=task_id.binary(),
            job_id=self.job_id.binary(),
            task_type=NORMAL_TASK,
            function_id=fid,
            function_blob=blob,
            function_name=name or fname,
            args=wire_args,
            kwargs=wire_kwargs,
            num_returns=num_returns,
            resources=ResourceSet(resources).to_wire(),
            owner_addr=self.direct_addr(),
            max_retries=max_retries,
            retry_exceptions=retry_exceptions,
            scheduling_strategy=_strategy_wire(scheduling_strategy),
            placement_group_id=(pg[0] if pg else None),
            placement_group_bundle_index=(pg[1] if pg else -1),
            runtime_env=runtime_env,
            trace_ctx=self._trace_for_submit(),
            replay_seed=_replay_seed(task_id.binary()),
        )

    def _finish_submit(self, spec: TaskSpec, task_id: TaskID,
                       creator_prefix: str, post_target,
                       *post_lead_args) -> List[ObjectRef]:
        """Shared submission tail: return-ref registration, record
        bookkeeping, PENDING event and the loop-thread post. ``post_target``
        receives ``(*post_lead_args, record)`` on the loop thread."""
        callsite = _user_callsite()
        num_returns = spec.num_returns
        if num_returns == -1:  # streaming generator
            record = TaskRecord(spec, [], callsite=callsite)
            from ray_tpu_torch._private.streaming import ObjectRefGenerator

            record.streaming_gen = ObjectRefGenerator(task_id.hex())
            self._tasks[task_id.binary()] = record
            self._pin_args(spec)
            self._record_task_event(spec, "PENDING")
            self._post(post_target, *post_lead_args, record)
            return record.streaming_gen
        return_ids = [ObjectID.for_task_return(task_id, i)
                      for i in range(num_returns)]
        refs = []
        creator = creator_prefix + spec.function_name
        for oid in return_ids:
            self.reference_counter.register_owned(
                oid, callsite=callsite, creator=creator,
                creator_id=task_id.hex())
            refs.append(ObjectRef(oid, self.direct_addr()))
        record = TaskRecord(spec, return_ids, callsite=callsite)
        self._tasks[task_id.binary()] = record
        self._pin_args(spec)
        self._record_task_event(spec, "PENDING")
        self._post(post_target, *post_lead_args, record)
        return refs

    def submit_many(
        self,
        function,
        args_list: List[tuple],
        kwargs_list: Optional[List[dict]] = None,
        num_returns: int = 1,
        resources: Optional[Dict[str, float]] = None,
        max_retries: int = -1,
        retry_exceptions: bool = False,
        scheduling_strategy=None,
        placement_group=None,
        placement_group_bundle_index: int = -1,
        runtime_env: Optional[Dict] = None,
        name: str = "",
    ) -> List[List[ObjectRef]]:
        """Vectorized :meth:`submit_task`: N calls of ONE
        (function, options) signature built in a single pass — one
        id-allocation block, one owner-ref registration batch, one trace
        stamp (a ``submit_batch::`` root span carrying ``count`` instead
        of N roots), one loop-thread post, and one PushTaskBatchStream
        frame per destination worker downstream. Returns one
        ``List[ObjectRef]`` per call, in submission order. Semantics are
        identical to a loop of ``submit_task`` calls — per-entry failure
        isolation, lineage and ownership included."""
        n = len(args_list)
        if n == 0:
            return []
        if num_returns < 0:
            raise ValueError(
                "submit_many does not support streaming tasks "
                "(num_returns='streaming')")
        if max_retries < 0:
            max_retries = CONFIG.task_max_retries_default
        if not CONFIG.submit_fastpath_enabled:
            return [
                self.submit_task(
                    function, args, (kwargs_list[i] if kwargs_list else {}),
                    num_returns=num_returns, resources=resources,
                    max_retries=max_retries,
                    retry_exceptions=retry_exceptions,
                    scheduling_strategy=scheduling_strategy,
                    placement_group=placement_group,
                    placement_group_bundle_index=placement_group_bundle_index,
                    runtime_env=runtime_env, name=name)
                for i, args in enumerate(args_list)
            ]
        self._n_tasks_submitted = \
            getattr(self, "_n_tasks_submitted", 0) + n
        tpl = self._task_template(
            function, num_returns, resources, max_retries, retry_exceptions,
            scheduling_strategy, placement_group,
            placement_group_bundle_index, runtime_env, name)
        t0 = time.time()
        tc = self._trace_for_submit()  # ONE stamp for the whole batch
        callsite = _user_callsite()
        task_ids = TaskID.random_block(n)
        wire_args_list = self._build_args_many(args_list)
        owner = self.direct_addr()
        counter = self.reference_counter
        tasks = self._tasks
        instantiate = tpl.instantiate
        records: List[TaskRecord] = []
        all_refs: List[List[ObjectRef]] = []
        reg_entries: List[Tuple[bytes, str]] = []
        ref_binaries: List[bytes] = []
        for i in range(n):
            tid = task_ids[i]
            tb = tid.binary()
            spec = instantiate(
                tb, wire_args_list[i],
                (self._build_kwargs(kwargs_list[i]) if kwargs_list
                 and kwargs_list[i] else {}),
                trace_ctx=None, replay_seed=_replay_seed(tb))
            tid_hex = tb.hex()
            refs = []
            return_ids = []
            for j in range(num_returns):
                oid = ObjectID.for_task_return(tid, j)
                ob = oid.binary()
                return_ids.append(oid)
                reg_entries.append((ob, tid_hex))
                ref_binaries.append(ob)
                ref = ObjectRef(oid, owner, _register=False)
                ref._registered = True
                refs.append(ref)
            record = TaskRecord(spec, return_ids, callsite=callsite)
            tasks[tb] = record
            records.append(record)
            all_refs.append(refs)
            if spec.args or spec.kwargs:
                self._pin_args(spec)
        fname = tpl.base["function_name"]
        counter.register_owned_batch(reg_entries, callsite=callsite,
                                     creator="task:" + fname)
        counter.add_local_refs_batch(ref_binaries)
        self._record_task_events_batch(records, "PENDING")
        if tc is not None:
            _events.REC.record(
                "submit_batch::" + fname, "task", t0,
                max(0.0, time.time() - t0), tc[0], tc[1],
                tc[2] if len(tc) > 2 else 0, {"count": n})
        self._post(self._submit_many_to_pool_sync, records)
        return all_refs

    def _build_kwargs(self, kwargs: dict) -> Dict[str, Tuple]:
        return {k: v for k, v in zip(kwargs.keys(),
                                     self._build_args(tuple(kwargs.values())))}

    def _record_task_events_batch(self, records: List[TaskRecord],
                                  state: str) -> None:
        """One append loop + one flush check for a submit_many batch —
        batched specs carry no per-task trace_ctx (the batch root span is
        recorded by the caller), so no span bookkeeping either."""
        now = time.time()
        events = self.task_events
        for r in records:
            spec = r.spec
            events.append((spec.task_id, spec.job_id, spec.function_name,
                           state, spec.task_type, now))
        if len(events) >= CONFIG.task_event_flush_batch:
            self.flush_task_events()

    def _submit_many_to_pool_sync(self, records: List[TaskRecord]) -> None:
        """Loop-thread landing for a submit_many batch: ONE lease-pool
        lookup (one signature = one scheduling key) and one deferred pump
        for the whole batch."""
        if not records:
            return
        key = records[0].spec.scheduling_key()
        pool = self._lease_pools.get(key)
        if pool is None:
            pool = _LeasePool(self, key, records[0].spec)
            self._lease_pools[key] = pool
        pool.submit_batch(records)

    def submit_xlang_task(
        self,
        function_name: str,
        args: tuple,
        *,
        language: str = "cpp",
        resources: Optional[Dict[str, float]] = None,
        num_returns: int = 1,
    ) -> List[ObjectRef]:
        """Submit a task to a worker of another LANGUAGE (reference:
        python/ray/cross_language.py cpp_function/java_function). Args are
        plain msgpack ("x" entries); the lease carries
        runtime_env={"language": ...} so the agent routes it to a
        matching self-registered worker (agent._try_grant lang_env)."""
        import msgpack as _mp

        from ray_tpu_torch._private.function_table import XLANG_PYREF_FID
        from ray_tpu_torch._private.resources import ResourceSet

        if num_returns != 1:
            raise ValueError(
                "cross-language tasks support num_returns=1 only (the "
                "foreign worker packages a single msgpack payload)")
        task_id = TaskID.from_random()
        spec = TaskSpec(
            task_id=task_id.binary(),
            job_id=self.job_id.binary(),
            task_type=NORMAL_TASK,
            function_id=XLANG_PYREF_FID,
            function_name=function_name,
            args=[("x", _mp.packb(a, use_bin_type=True)) for a in args],
            kwargs={},
            num_returns=num_returns,
            resources=ResourceSet(dict(resources or {"CPU": 1.0})).to_wire(),
            owner_addr=self.direct_addr(),
            max_retries=0,
            runtime_env={"language": language},
        )
        callsite = _user_callsite()
        return_ids = [ObjectID.for_task_return(task_id, i)
                      for i in range(num_returns)]
        refs = []
        for oid in return_ids:
            self.reference_counter.register_owned(
                oid, callsite=callsite, creator="task:" + function_name,
                creator_id=task_id.hex())
            refs.append(ObjectRef(oid, self.direct_addr()))
        record = TaskRecord(spec, return_ids, callsite=callsite)
        self._tasks[task_id.binary()] = record
        self._record_task_event(spec, "PENDING")
        self._post(self._submit_to_pool_sync, record)
        return refs

    def _build_args(self, args: tuple) -> List:
        """Top-level refs pass by reference (inlining small resolved values);
        plain values serialize, collecting nested refs for pinning."""
        wire = []
        for a in args:
            if isinstance(a, ObjectRef):
                entry = self.memory_store.get(a.binary())
                if entry is not None and entry[1] == VAL:
                    wire.append(("iv", entry[0]))  # inlined pre-serialized value
                else:
                    wire.append(("r", a.binary(), a.owner_addr()))
            else:
                sobj = self._serialize_value(a)
                wire.append(("v", sobj.to_bytes()))
        return wire

    def _build_args_many(self, args_list: List[tuple]) -> List[List]:
        """Batch arg wiring for submit_many: same per-entry semantics as
        :meth:`_build_args`, plus a per-batch serialization memo so an
        object shared across the batch's calls serializes once."""
        from ray_tpu_torch._private.serialization import SerializeMemo

        memo = SerializeMemo()
        ser_memoized = self.serialization_context.serialize_memoized
        mget = self.memory_store.get
        out = []
        for args in args_list:
            wire = []
            for a in args:
                if isinstance(a, ObjectRef):
                    entry = mget(a.binary())
                    if entry is not None and entry[1] == VAL:
                        wire.append(("iv", entry[0]))
                    else:
                        wire.append(("r", a.binary(), a.owner_addr()))
                else:
                    ctx = ser.get_reducer_context()
                    ctx.collected_refs = []
                    try:
                        wire.append(("v", ser_memoized(a, memo)))
                    finally:
                        ctx.collected_refs = None
            out.append(wire)
        return out

    def _pin_args(self, spec: TaskSpec) -> None:
        for entry in list(spec.args) + list(spec.kwargs.values()):
            if entry[0] == "r":
                self.reference_counter.pin_for_task(entry[1])

    def _unpin_args(self, spec: TaskSpec) -> None:
        for entry in list(spec.args) + list(spec.kwargs.values()):
            if entry[0] == "r":
                self.reference_counter.unpin_for_task(entry[1])

    def _submit_to_pool_sync(self, record: TaskRecord) -> None:
        key = record.spec.scheduling_key()
        pool = self._lease_pools.get(key)
        if pool is None:
            pool = _LeasePool(self, key, record.spec)
            self._lease_pools[key] = pool
        pool.submit(record)

    # ----------------------------------------------------- completion paths
    def _completion_enqueue(self, cb, i, reply) -> None:
        """Batched completion delivery: per-item completions
        landing on the read-loop side in one burst — BatchItems frames, or
        several frames draining in one loop pass — buffer here and resolve
        together in ONE deferred drain, so N inline returns cost one
        memory-store lock pass and one resolved-state pass instead of N."""
        if _sanitizer.ENABLED:
            _sanitizer.note_affinity("Worker._completion_buf", "loop")
        self._completion_buf.append((cb, i, reply))
        if not self._completions_armed:
            self._completions_armed = True
            self.loop.call_soon(self._drain_completions)

    def _drain_completions(self) -> None:
        if _sanitizer.ENABLED:
            _sanitizer.note_affinity("Worker._completion_buf", "loop")
        self._completions_armed = False
        buf = self._completion_buf
        if not buf:
            return
        self._completion_buf = []
        # while the sink is armed, _resolve_return diverts inline
        # resolutions into it instead of writing through per id
        sink = self._resolve_sink = []
        try:
            for cb, i, reply in buf:
                try:
                    cb(i, reply)
                except Exception:
                    import logging

                    logging.getLogger("ray_tpu_torch").exception(
                        "error in batched completion delivery")
        finally:
            self._resolve_sink = None
        if not sink:
            return
        self.memory_store.put_batch(sink)
        self.reference_counter.set_resolved_batch(
            [(b, ("error" if f == EXC else "inline"), len(d))
             for b, d, f in sink])

    def _on_task_reply(self, record: TaskRecord, reply: Dict) -> None:
        if record.completed:
            return  # cancelled or already resolved; late reply is dropped
        spec = record.spec
        if (
            reply.get("error")
            and spec.retry_exceptions
            and record.attempts < spec.max_retries
            and not record.cancelled
            # streaming: consumed yields can't be replayed transparently
            and record.streaming_gen is None
        ):
            record.attempts += 1
            self._record_task_event(spec, "RETRYING")
            self._submit_to_pool_sync(record)
            return
        record.completed = True
        if record.streaming_gen is None:
            # Lineage retention decides the arg pins' fate: a
            # retained record KEEPS them so the producing chain stays
            # replayable; everything else releases them here, exactly
            # once (a retained record's unpin happens when the record is
            # released — last output freed, cap eviction, or terminal
            # failure of a replay).
            if not self._maybe_retain_lineage(record, reply):
                self._lineage.discard(spec.task_id)
                self._unpin_args(spec)
        else:
            self._unpin_args(spec)
        if record.streaming_gen is not None:
            # items already arrived via StreamingReturn; the reply only
            # closes the stream (a pre-generator error closes it broken)
            err = None
            if reply.get("error"):
                blob = reply.get("error_inline")
                if blob is not None:
                    try:
                        err = self.serialization_context.deserialize(
                            memoryview(blob))
                    except Exception:
                        err = None
                if err is None:
                    err = RayTaskError(
                        spec.function_name,
                        "streaming task failed before yielding")
            record.streaming_gen._finish(err)
            # streaming_failed: mid-stream exception was delivered as the
            # final ref (stream itself closed cleanly) — observability must
            # still record the task as FAILED
            ok = not reply.get("error") and not reply.get("streaming_failed")
            self._record_task_event(spec, "FINISHED" if ok else "FAILED")
            self._maybe_drop_streaming_record(record)
            return
        returns = reply.get("returns", [])
        for oid, ret in zip(record.return_ids, returns):
            self._resolve_return(oid, ret)
        self._record_task_event(spec, "FINISHED" if not reply.get("error")
                                else "FAILED")
        if spec.task_type == NORMAL_TASK and not reply.get("error"):
            # Keep the record for lineage-based recovery of plasma returns;
            # drop it if every return was inline (nothing to reconstruct).
            if all(r.get("inline") is not None for r in returns):
                self._tasks.pop(spec.task_id, None)

    def _maybe_retain_lineage(self, record: TaskRecord, reply: Dict) -> bool:
        """Should this completed task's record (spec + pinned args) be
        retained as replayable lineage? Yes iff it is a successful
        NORMAL_TASK that opted into retries and produced at least one
        plasma return whose ref is still live."""
        spec = record.spec
        if (spec.task_type != NORMAL_TASK or spec.max_retries <= 0
                or reply.get("error")):
            return False
        if self._tasks.get(spec.task_id) is not record:
            return False  # evicted mid-replay: pins already released
        plasma = [
            oid.binary()
            for oid, ret in zip(record.return_ids, reply.get("returns", []))
            if ret.get("inline") is None and ret.get("xlang") is None
            and ret.get("xlang_error") is None
        ]
        plasma = [b for b in plasma
                  if self.reference_counter.get_owned_meta(b) is not None]
        if not plasma:
            return False
        return self._lineage.retain(record, plasma)

    def _maybe_drop_streaming_record(self, record: TaskRecord) -> None:
        """Drop a COMPLETED streaming task's record unconditionally: the
        executor acks every yield before the closing reply, so no more
        StreamingReturn items can need routing, and streaming tasks have
        no retry/lineage path that would reread the record. Keeping it
        until every yield was freed (the old conditional) pinned an
        ABANDONED generator forever: _tasks -> record -> generator ->
        queued refs -> owned metas, a cycle anchored by the worker that
        no gc pass may collect — the ref-leak gate caught a
        replica-killed mid-stream call leaking exactly this way."""
        self._tasks.pop(record.spec.task_id, None)

    def _resolve_return(self, oid: ObjectID, ret: Dict) -> None:
        if self.reference_counter.get_owned_meta(oid.binary()) is None:
            # every ref was dropped while the task ran: caching the value
            # now would leak the entry (no-resurrect contract in
            # set_resolved), and a plasma copy the executor already
            # sealed would leak its BYTES — free it at its node
            node_addr = ret.get("node_addr")
            if ret.get("inline") is None and node_addr and self.connected:
                hex_id = oid.hex()

                async def free_orphan():
                    try:
                        if node_addr == self.agent_tcp_addr:
                            await self.agent.call(
                                "FreeObjects", {"ids": [hex_id]},
                                timeout=CONFIG.control_rpc_timeout_s)
                        else:
                            client = await self._owner_client(node_addr)
                            await client.call(
                                "FreeObjects", {"ids": [hex_id]},
                                timeout=CONFIG.control_rpc_timeout_s)
                    except Exception:
                        pass

                self._spawn(free_orphan())
            return
        if ret.get("xlang") is not None:
            # cross-language return (a C++ worker's msgpack payload):
            # re-encode with the local context so ray_tpu_torch.get is uniform
            # (reference: cross_language.py msgpack deserialization)
            import msgpack as _mp

            value = _mp.unpackb(ret["xlang"], raw=False)
            data = self._serialize_value(value).to_bytes()
            self.memory_store.put(oid.binary(), data, VAL)
            self.reference_counter.set_resolved(oid.binary(), "inline")
            return
        if ret.get("xlang_error") is not None:
            err = RayTaskError("cross-language task",
                               str(ret["xlang_error"]))
            data = self._serialize_value(err).to_bytes()
            self.memory_store.put(oid.binary(), data, EXC)
            self.reference_counter.set_resolved(oid.binary(), "error")
            return
        if ret.get("inline") is not None:
            flags = EXC if ret.get("is_exception") else VAL
            sink = self._resolve_sink
            if sink is not None:
                # batched completion drain in progress: divert into the
                # sink; the drain writes the whole batch through in one
                # put_batch + set_resolved_batch pass (same per-object
                # ordering — value lands before its resolved state)
                sink.append((oid.binary(), ret["inline"], flags))
                return
            self.memory_store.put(oid.binary(), ret["inline"], flags)
            self.reference_counter.set_resolved(
                oid.binary(), "error" if flags == EXC else "inline",
                size=len(ret["inline"])
            )
        else:
            self.memory_store.put(oid.binary(), b"", IN_PLASMA)
            self.reference_counter.set_resolved(
                oid.binary(), "plasma", [ret.get("node_addr")],
                size=int(ret.get("size") or 0)
            )

    def _count_task_failure(self) -> None:
        self._n_task_failures = getattr(self, "_n_task_failures", 0) + 1

    def _on_task_failure(self, record: TaskRecord, error: Exception,
                         retriable: bool = True) -> None:
        if record.completed:
            return
        self._count_task_failure()
        spec = record.spec
        record.attempts += 1
        if record.streaming_gen is not None:
            # no retries for streaming generators: already-consumed yields
            # can't be replayed transparently (reference restriction too)
            record.completed = True
            self._unpin_args(spec)
            err = error if isinstance(error, Exception) else RayTaskError(
                spec.function_name, str(error))
            record.streaming_gen._finish(err)
            self._record_task_event(spec, "FAILED")
            self._maybe_drop_streaming_record(record)
            return
        if retriable and record.attempts <= spec.max_retries and not record.cancelled:
            self._record_task_event(spec, "RETRYING")
            self._submit_to_pool_sync(record)
            return
        record.completed = True
        # a replay's terminal failure must release the retained record's
        # ledger entry BEFORE the single unpin below (else the later
        # record drop would unpin a second time)
        self._lineage.discard(spec.task_id)
        self._unpin_args(spec)
        err = error if isinstance(error, Exception) else RayTaskError(
            spec.function_name, str(error)
        )
        data = self._serialize_value(err).to_bytes()
        for oid in record.return_ids:
            if self.reference_counter.get_owned_meta(oid.binary()) is None:
                continue  # ref dropped mid-flight: don't leak the error blob
            self.memory_store.put(oid.binary(), data, EXC)
            self.reference_counter.set_resolved(oid.binary(), "error")
        self._record_task_event(spec, "FAILED")

    def _record_task_event(self, spec: TaskSpec, state: str) -> None:
        # hot path: one tuple append, no dicts/hex (the wire + head store
        # stay columnar; the state API renders dicts only on query —
        # reference analog: TaskEventBuffer batches binary protos,
        # task_event_buffer.h:206)
        tc = spec.trace_ctx
        if tc is not None and state in ("FINISHED", "FAILED"):
            # close the sampled root span: submit -> reply, one per
            # attempt chain (retries extend the same span)
            rec = _events.REC
            if rec.enabled:
                record = self._tasks.get(spec.task_id)
                t0 = record.submitted_at if record is not None else time.time()
                name = ("actor_call::" if spec.task_type == ACTOR_TASK
                        else "task::") + spec.function_name
                rec.record(name, "task", t0, max(0.0, time.time() - t0),
                           tc[0], tc[1], tc[2] if len(tc) > 2 else 0,
                           {"task": spec.task_id.hex()[:16], "state": state})
        self.task_events.append(
            (spec.task_id, spec.job_id, spec.function_name, state,
             spec.task_type, time.time()))
        if len(self.task_events) >= CONFIG.task_event_flush_batch:
            self.flush_task_events()

    def flush_task_events(self, wait: bool = False) -> None:
        """Flush buffered task state events AND the flight-recorder ring
        to the head. ``wait=True`` (timeline(), shutdown) blocks until the
        head ACKED the frame, so an immediately following ListTaskEvents/
        ListSpans is read-your-writes — the fix for the old
        ``time.sleep(0.05)`` flush race (satellite)."""
        events, self.task_events = self.task_events, []
        rec = _events.REC
        spans = rec.drain() if rec.enabled else []
        if (not events and not spans) or not self.head or not self.connected:
            return
        self._last_span_flush = time.monotonic()
        payload = {"events_v2": events, "node_id": self.node_id,
                   "spans": spans, "role": self.mode,
                   "pid": os.getpid(),
                   # None when disarmed: a ring entry in the frame is what
                   # creates per-node recorder stats head-side
                   "ring": rec.stats() if rec.enabled else None}
        if wait and threading.current_thread() is not self._loop_thread:
            try:
                self._acall(self.head.call(
                    "ReportTaskEvents", payload,
                    timeout=CONFIG.control_rpc_timeout_s),
                    timeout=CONFIG.control_rpc_timeout_s)
            except Exception:
                pass
            return

        async def send():
            try:
                await self.head.call(
                    "ReportTaskEvents", payload,
                    timeout=CONFIG.control_rpc_timeout_s)
            except Exception:
                pass

        self._spawn(send())

    def _maybe_flush_spans(self) -> None:
        """Executor-side pacing: push recorded spans to the head at most
        every task_event_flush_interval_s, so a timeline pulled moments
        after a task finishes already has its worker-side slices. Too-
        early calls arm ONE deferred flush for the window's end — a task
        that runs once and never again still gets its spans out without
        waiting for the 15 s worker watchdog (loop-thread only)."""
        rec = _events.REC
        if not rec.enabled or rec.counter == rec.flushed:
            return
        now = time.monotonic()
        due = getattr(self, "_last_span_flush", 0.0) + \
            CONFIG.task_event_flush_interval_s
        if now >= due:
            self.flush_task_events()
            return
        if not getattr(self, "_span_flush_armed", False):
            self._span_flush_armed = True
            self.loop.call_later(max(0.05, due - now),
                                 self._deferred_span_flush)

    def _deferred_span_flush(self) -> None:
        self._span_flush_armed = False
        rec = _events.REC
        if self.connected and rec.enabled and rec.counter != rec.flushed:
            self.flush_task_events()

    def cancel_task(self, ref: ObjectRef, force: bool = False) -> None:
        record = self._tasks.get(ref.id().task_id().binary())
        if record is None:
            return
        record.cancelled = True
        self._on_task_failure(record, TaskCancelledError(ref.id().task_id().hex()),
                              retriable=False)

    # ================================================================= actors
    def create_actor(
        self,
        cls,
        args: tuple,
        kwargs: dict,
        resources: Optional[Dict[str, float]] = None,
        max_restarts: int = 0,
        max_concurrency: int = 1,
        name: str = "",
        namespace: str = "default",
        lifetime: Optional[str] = None,
        get_if_exists: bool = False,
        scheduling_strategy=None,
        placement_group=None,
        placement_group_bundle_index: int = -1,
        runtime_env: Optional[Dict] = None,
    ) -> Tuple[ActorID, Dict]:
        actor_id = ActorID.from_random()
        class_blob = ser.dumps(cls)
        from ray_tpu_torch._private.resources import ResourceSet

        # Reference semantics: actors hold 0 CPU while alive unless the user
        # asked for CPUs explicitly (reference: ray actor default num_cpus=0
        # at runtime), so long-lived actors don't starve task leases.
        resources = dict(resources or {})
        pg = None
        if placement_group is not None:
            pg = [placement_group.id_hex, max(placement_group_bundle_index, 0)]
        spec_wire = {
            "actor_id": actor_id.hex(),
            "class_blob": class_blob,
            "class_name": getattr(cls, "__name__", "Actor"),
            "init_args": self._build_args(args),
            "init_kwargs": {k: v for k, v in zip(
                kwargs.keys(), self._build_args(tuple(kwargs.values())))},
            "resources": ResourceSet(resources).to_wire(),
            "max_restarts": max_restarts,
            "max_concurrency": max_concurrency,
            "detached": lifetime == "detached",
            "name": name,
            "namespace": namespace,
            "owner_addr": self.direct_addr(),
            "job_id": self.job_id.hex(),
            "scheduling_strategy": _strategy_wire(scheduling_strategy),
            "pg": pg,
            "runtime_env": runtime_env,
        }
        self._ensure_actor_subscription()
        # Track before the CreateActor RPC so a fast ActorReady event can't
        # race past the state registration.
        self._track_actor(actor_id, {"state": "PENDING_CREATION"})
        payload = {
            "actor_id": actor_id.hex(),
            "spec": spec_wire,
            "name": name,
            "namespace": namespace,
            "max_restarts": max_restarts,
            "get_if_exists": get_if_exists,
        }
        # Anonymous creates coalesce: the actor id is client-
        # generated and the only RPC-surfaced error (name taken) cannot
        # apply, so the create can ride the next CreateActorBatch frame —
        # a 1,000-actor burst pays ~4 head round trips instead of 1,000
        # serial ones. Named / get_if_exists creates keep the blocking
        # path: their reply (existing view, ValueError) is load-bearing.
        if not name and not get_if_exists \
                and CONFIG.actor_create_batch_window_ms > 0:
            self._acall(self._enqueue_create(payload))
            return actor_id, {"actor_id": actor_id.hex(),
                              "state": "PENDING_CREATION"}
        reply = self.head_call("CreateActor", payload)
        if reply.get("existing"):
            view = reply["existing"]
            existing_id = ActorID.from_hex(view["actor_id"])
            st = self._track_actor(existing_id, view)
            if st.state != "ALIVE":
                # as in get_named_actor
                self._refetch_actor(st)
            return existing_id, view
        self._track_actor(actor_id, {"state": "PENDING_CREATION"})
        return actor_id, reply

    # ------------------------------------- batched actor creation
    async def _enqueue_create(self, payload: Dict) -> None:
        """Loop-side: queue one anonymous create; arm (or ride) the flush
        window. Never awaits the RPC — create_actor returns immediately
        and failures surface through the tracked actor state (DEAD with a
        death_cause), exactly like any other post-ack actor failure."""
        self._pending_creates.append(payload)
        if len(self._pending_creates) >= CONFIG.actor_create_batch_max:
            self._create_flush_now()
        elif not self._create_flush_armed:
            self._create_flush_armed = True
            self.loop.call_later(
                max(CONFIG.actor_create_batch_window_ms, 0) / 1000.0,
                self._create_flush_now)

    def _create_flush_now(self) -> None:
        self._create_flush_armed = False
        if not self._pending_creates:
            return
        batch, self._pending_creates = self._pending_creates, []
        self._create_inflight += 1
        self._spawn(self._send_create_batch(batch))

    async def _send_create_batch(self, batch: List[Dict]) -> None:
        try:
            reply = await self._head_call_async(
                "CreateActorBatch", {"items": batch})
            by_id = {r.get("actor_id"): r
                     for r in (reply or {}).get("results", []) if r}
            for item in batch:
                r = by_id.get(item["actor_id"])
                if r is None or r.get("error"):
                    self._fail_create(
                        item, r.get("error") if r else "create lost")
        except Exception as e:
            for item in batch:
                self._fail_create(item, repr(e))
        finally:
            self._create_inflight -= 1

    def _fail_create(self, item: Dict, msg: str) -> None:
        self._track_actor(
            ActorID.from_hex(item["actor_id"]),
            {"actor_id": item["actor_id"], "state": "DEAD",
             "death_cause": f"actor creation failed: {msg}"})

    async def _drain_actor_creates(self) -> None:
        """Flush + await every queued/in-flight batched create. Ordering
        barrier for head calls that must observe prior creates (KillActor,
        GetActor, shutdown)."""
        while self._pending_creates or self._create_inflight:
            self._create_flush_now()
            await asyncio.sleep(0.002)

    def _ensure_actor_subscription(self):
        if self._actor_sub_started:
            return

        async def sub():
            # checked and set on the loop, so that callers on two threads
            # subscribe once
            if self._actor_sub_started:
                return
            self._actor_sub_started = True
            try:
                await self.head.call("Subscribe", {"channels": ["actor"]},
                                     timeout=CONFIG.control_rpc_timeout_s)
            except Exception:
                # head link not up yet (lazy worker-mode connect) or mid-
                # outage: _connect_head re-subscribes off the already-set
                # _actor_sub_started flag when the link lands
                pass

        self._acall(sub())

    def _track_actor(self, actor_id: ActorID, view: Dict) -> "_ActorState":
        st = self._actor_states.get(actor_id.binary())
        if st is None:
            st = _ActorState(actor_id)
            self._actor_states[actor_id.binary()] = st
        st.update(view, self)
        return st

    def _on_actor_event(self, view: Dict) -> None:
        actor_id = ActorID.from_hex(view["actor_id"])
        st = self._actor_states.get(actor_id.binary())
        if st is not None:
            st.update(view, self)
            if st.state == "DEAD":
                self._prune_dead_actor_states()

    def _prune_dead_actor_states(self, cap: int = 256) -> None:
        """Caller-side dead-actor cache cap (raylint R10): a long-lived
        driver churning actors must not keep a pipeline object for every
        actor that ever died. DEAD states with nothing queued are safe to
        drop — a late call through a surviving handle re-fetches the
        (dead) view from the head and fails the same way."""
        dead = [b for b, st in self._actor_states.items()
                if st.state == "DEAD" and not st.queue and not st._retry_buf]
        if len(dead) <= cap:
            return
        for b in dead[:len(dead) - cap]:
            self._actor_states.pop(b, None)

    def actor_state_for(self, actor_id: ActorID) -> "_ActorState":
        st = self._actor_states.get(actor_id.binary())
        if st is None:
            st = self._track_actor(actor_id, {"state": "PENDING_CREATION"})
            self._ensure_actor_subscription()
            self._refetch_actor(st)
        return st

    def _refetch_actor(self, st: "_ActorState") -> None:
        """Read the head's view of ``st``'s actor again, in the background.
        Actor events for an actor this process does not track yet are
        dropped, so a view read before the actor was tracked can miss the
        transitions since (the ALIVE of an actor looked up while it was
        PENDING_CREATION): the calls queued on it would wait forever."""
        actor_id = st.actor_id

        async def fetch():
            # a batched anonymous create may still be queued locally:
            # flush it first so the head can answer; outage-queued
            # (_head_call_async) so a worker's lazy head connect or a
            # head bounce delays rather than loses the fetch
            await self._drain_actor_creates()
            view = await self._head_call_async(
                "GetActor", {"actor_id": actor_id.hex()},
                timeout=CONFIG.control_rpc_timeout_s)
            if view:
                st.update(view, self)

        self._spawn(fetch())

    def submit_actor_task(
        self,
        actor_id: ActorID,
        method_name: str,
        args: tuple,
        kwargs: dict,
        num_returns: int = 1,
        max_retries: int = 0,
    ) -> List[ObjectRef]:
        self._n_actor_calls = getattr(self, "_n_actor_calls", 0) + 1
        st = self.actor_state_for(actor_id)
        seq = st.next_seq()
        task_id = TaskID.for_actor_task(actor_id, seq, self.worker_id.binary())
        if max_retries < 0:
            # reference semantics: -1 = retry indefinitely
            max_retries = 2 ** 31
        wire_args = self._build_args(args) if args else []
        wire_kwargs = self._build_kwargs(kwargs) if kwargs else {}
        if CONFIG.submit_fastpath_enabled:
            tpl = self._actor_template(actor_id, method_name, num_returns,
                                       max_retries)
            spec = tpl.instantiate(
                task_id.binary(), wire_args, wire_kwargs,
                trace_ctx=self._trace_for_submit(), seq=seq)
        else:
            spec = TaskSpec(
                task_id=task_id.binary(),
                job_id=self.job_id.binary(),
                task_type=ACTOR_TASK,
                function_id=b"\x00" * 16,
                function_name=method_name,
                args=wire_args,
                kwargs=wire_kwargs,
                num_returns=num_returns,
                resources={},
                owner_addr=self.direct_addr(),
                actor_id=actor_id.binary(),
                actor_method=method_name,
                seq=seq,
                max_retries=max_retries,
                trace_ctx=self._trace_for_submit(),
            )
        return self._finish_submit(spec, task_id, "actor:", st.enqueue, self)

    def _actor_template(self, actor_id: ActorID, method_name: str,
                        num_returns: int, max_retries: int) -> SpecTemplate:
        """Frozen spec template for one (actor, method, options) signature
        — the actor-call analog of :meth:`_task_template` (no function
        blob: the method resolves executor-side from the actor's class)."""
        key = ("actor", actor_id.binary(), method_name, num_returns,
               max_retries)
        tpl = self._spec_templates.get(key)
        if tpl is not None:
            return tpl
        tpl = SpecTemplate(
            job_id=self.job_id.binary(),
            task_type=ACTOR_TASK,
            function_id=b"\x00" * 16,
            function_name=method_name,
            num_returns=num_returns,
            resources={},
            owner_addr=self.direct_addr(),
            actor_id=actor_id.binary(),
            actor_method=method_name,
            max_retries=max_retries,
        )
        if len(self._spec_templates) >= CONFIG.spec_template_cache_max:
            self._spec_templates.clear()
        self._spec_templates[key] = tpl
        return tpl

    def submit_actor_tasks_many(
        self,
        calls: List[Tuple],
        num_returns: int = 1,
        max_retries: int = 0,
    ) -> List[List[ObjectRef]]:
        """Vectorized :meth:`submit_actor_task`. ``calls`` is
        ``[(actor_id, method_name, args, kwargs)]`` — possibly spanning
        MANY actors (the serve controller's replica fan-outs broadcast one
        method across every replica). Per-actor seq order follows list
        order; records land on each actor's queue as one batch, so a
        same-actor run of calls rides one PushTaskBatchStream frame."""
        n = len(calls)
        if n == 0:
            return []
        if num_returns < 0:
            raise ValueError(
                "submit_actor_tasks_many does not support streaming calls")
        if max_retries < 0:
            max_retries = 2 ** 31
        if not CONFIG.submit_fastpath_enabled:
            return [
                self.submit_actor_task(aid, method, args, kwargs,
                                       num_returns=num_returns,
                                       max_retries=max_retries)
                for aid, method, args, kwargs in calls
            ]
        self._n_actor_calls = getattr(self, "_n_actor_calls", 0) + n
        t0 = time.time()
        tc = self._trace_for_submit()  # ONE stamp for the whole batch
        callsite = _user_callsite()
        owner = self.direct_addr()
        wid = self.worker_id.binary()
        tasks = self._tasks
        records: List[TaskRecord] = []
        all_refs: List[List[ObjectRef]] = []
        reg_entries: List[Tuple] = []
        ref_binaries: List[bytes] = []
        groups: Dict[int, Tuple] = {}  # id(state) -> (state, [records])
        for actor_id, method_name, args, kwargs in calls:
            st = self.actor_state_for(actor_id)
            seq = st.next_seq()
            task_id = TaskID.for_actor_task(actor_id, seq, wid)
            tb = task_id.binary()
            tpl = self._actor_template(actor_id, method_name, num_returns,
                                       max_retries)
            spec = tpl.instantiate(
                tb, self._build_args(args) if args else [],
                self._build_kwargs(kwargs) if kwargs else {},
                trace_ctx=None, seq=seq)
            tid_hex = tb.hex()
            creator = "actor:" + method_name
            refs = []
            return_ids = []
            for j in range(num_returns):
                oid = ObjectID.for_task_return(task_id, j)
                ob = oid.binary()
                return_ids.append(oid)
                reg_entries.append((ob, tid_hex, creator))
                ref_binaries.append(ob)
                ref = ObjectRef(oid, owner, _register=False)
                ref._registered = True
                refs.append(ref)
            record = TaskRecord(spec, return_ids, callsite=callsite)
            tasks[tb] = record
            if spec.args or spec.kwargs:
                self._pin_args(spec)
            records.append(record)
            all_refs.append(refs)
            grp = groups.get(id(st))
            if grp is None:
                groups[id(st)] = grp = (st, [])
            grp[1].append(record)
        counter = self.reference_counter
        counter.register_owned_batch(reg_entries, callsite=callsite)
        counter.add_local_refs_batch(ref_binaries)
        self._record_task_events_batch(records, "PENDING")
        if tc is not None:
            _events.REC.record(
                "submit_batch::actor_calls", "task", t0,
                max(0.0, time.time() - t0), tc[0], tc[1],
                tc[2] if len(tc) > 2 else 0, {"count": n})
        self._post(self._enqueue_actor_batches_sync, list(groups.values()))
        return all_refs

    def _enqueue_actor_batches_sync(self, groups: List[Tuple]) -> None:
        for st, records in groups:
            st.enqueue_batch(self, records)

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True) -> None:
        # order after any queued batched create: the head must know the
        # actor before it can kill it (a reordered kill would no-op and
        # the later create would leak a live actor)
        self._acall(self._drain_actor_creates())
        self.head_call(
            "KillActor",
            {"actor_id": actor_id.hex(), "no_restart": no_restart})

    # --------------------------------------------------------------- helpers
    def get_named_actor(self, name: str, namespace: str = "default"):
        view = self.head_call(
            "GetNamedActor", {"name": name, "namespace": namespace})
        if view is None or view.get("state") == "DEAD":
            raise ValueError(f"Failed to look up actor '{name}' in namespace "
                             f"'{namespace}'")
        actor_id = ActorID.from_hex(view["actor_id"])
        self._ensure_actor_subscription()
        st = self._track_actor(actor_id, view)
        if st.state != "ALIVE":
            # Port fix (the reference has the window): its ALIVE may have
            # been published between the lookup and the tracking
            self._refetch_actor(st)
        return actor_id, view

    def kv(self):
        return KvClient(self)


_LOST = object()


def _strategy_wire(strategy) -> Optional[Dict]:
    if strategy is None:
        return None
    if isinstance(strategy, str):
        if strategy == "SPREAD":
            return {"type": "spread"}
        if strategy == "DEFAULT":
            return None
        return None
    # NodeAffinitySchedulingStrategy / PlacementGroupSchedulingStrategy objects
    t = type(strategy).__name__
    if t == "NodeAffinitySchedulingStrategy":
        return {"type": "node_affinity", "node_id": strategy.node_id,
                "soft": strategy.soft}
    if t == "SpreadSchedulingStrategy":
        return {"type": "spread"}
    if t == "NodeLabelSchedulingStrategy":
        from ray_tpu_torch._private.resources import normalize_label_constraints

        return {"type": "node_label",
                "hard": normalize_label_constraints(strategy.hard),
                "soft": normalize_label_constraints(strategy.soft)}
    return None


class KvClient:
    """Synchronous KV facade over the head's internal KV
    (reference: gcs_kv_manager.h / experimental.internal_kv)."""

    def __init__(self, worker: Worker):
        self._w = worker

    def put(self, key: bytes, value: bytes, overwrite: bool = True,
            namespace: str = "default") -> bool:
        return self._w._acall(self._w.head.call(
            "KvPut", {"key": key, "value": value, "overwrite": overwrite,
                      "ns": namespace},
            timeout=CONFIG.control_rpc_timeout_s))

    def get(self, key: bytes, namespace: str = "default") -> Optional[bytes]:
        return self._w._acall(self._w.head.call(
            "KvGet", {"key": key, "ns": namespace},
            timeout=CONFIG.control_rpc_timeout_s))

    def delete(self, key: bytes, prefix: bool = False,
               namespace: str = "default") -> int:
        return self._w._acall(self._w.head.call(
            "KvDel", {"key": key, "prefix": prefix, "ns": namespace},
            timeout=CONFIG.control_rpc_timeout_s))

    def keys(self, prefix: bytes = b"", namespace: str = "default") -> List[bytes]:
        return self._w._acall(self._w.head.call(
            "KvKeys", {"prefix": prefix, "ns": namespace},
            timeout=CONFIG.control_rpc_timeout_s))

    def exists(self, key: bytes, namespace: str = "default") -> bool:
        return self._w._acall(self._w.head.call(
            "KvExists", {"key": key, "ns": namespace},
            timeout=CONFIG.control_rpc_timeout_s))


# ---------------------------------------------------------------------------
# Direct task submitter internals (loop-owned)
# ---------------------------------------------------------------------------


class _PlacementGroupGone(Exception):
    """The target placement group was removed; queued tasks must fail."""


class _RuntimeEnvFailed(Exception):
    """The agent could not materialize a spawn-time runtime_env (conda /
    container); retrying the lease would fail identically."""


class _LeasePool:
    """Lease cache for one scheduling key (reference:
    direct_task_transport.h SchedulingKey entry): grab workers from agents,
    pipeline tasks onto idle leased workers, return leases after idle TTL."""

    # read per-use so head-broadcast cluster config applies (registration
    # runs after module import)
    @property
    def IDLE_TTL(self) -> float:
        return CONFIG.lease_idle_ttl_ms / 1000.0

    @property
    def MAX_WORKERS(self) -> int:
        return CONFIG.lease_max_workers_per_pool
    # Pipelining: tasks committed to a busy worker cannot be stolen back, so
    # depth >1 can strand a short task behind a long one — but it overlaps
    # RPC transport with execution (reference pipelines the same way in
    # direct_task_transport.h). Configurable via lease_pipeline_depth.
    @property
    def PIPELINE_DEPTH(self) -> int:
        return CONFIG.lease_pipeline_depth

    def __init__(self, worker: Worker, key, spec: TaskSpec):
        self.worker = worker
        self.key = key
        self.resources = spec.resources
        self.strategy = spec.scheduling_strategy
        self.pg = ([spec.placement_group_id, spec.placement_group_bundle_index]
                   if spec.placement_group_id else None)
        from ray_tpu_torch._private.task_spec import runtime_env_key

        # agents only hand this lease workers whose applied runtime_env
        # matches (or pristine ones) — see agent._pop_idle_worker
        self.env_key = runtime_env_key(spec.runtime_env)
        # container/conda envs are applied by the AGENT at worker spawn
        # (the process must start inside the image / under the env's
        # interpreter), so the spec rides the lease request
        # (runtime_env/container.py, runtime_env/conda.py)
        self.container = (spec.runtime_env or {}).get("container")
        self.conda = (spec.runtime_env or {}).get("conda")
        self.retriable = spec.max_retries > 0
        self.pending: deque = deque()
        self.conns: List[WorkerConn] = []
        self.idle: List[WorkerConn] = []
        self.inflight_leases = 0
        self._exec_ms_ema: Optional[float] = None
        # per-function exec EMAs: the pool-wide EMA sizes the pipeline,
        # but whether it is safe to stack behind a specific head-of-line
        # task depends on THAT function's history (see _conn_depth)
        # raylint: disable=R10 -- bounded: one float per function NAME
        # submitted through this scheduling key — grows with code, not
        # traffic, and the pool itself dies with its idle TTL
        self._fn_ema: Dict[str, float] = {}
        self._reaper: Optional[asyncio.Task] = None
        self._pump_scheduled = False

    def _note_exec_ms(self, fn_name: str, ms: float) -> None:
        prev = self._exec_ms_ema
        self._exec_ms_ema = ms if prev is None else 0.8 * prev + 0.2 * ms
        prev_fn = self._fn_ema.get(fn_name)
        self._fn_ema[fn_name] = ms if prev_fn is None \
            else 0.8 * prev_fn + 0.2 * ms

    def _depth(self) -> int:
        """Adaptive pipelining: short tasks go deep so one worker wakeup
        drains a batch of frames (amortizing context switches); long tasks
        stay shallow so queued work can spread onto fresh leases."""
        e = self._exec_ms_ema
        if e is None:
            # duration unknown: committing a second task to a busy worker
            # can strand it behind an arbitrarily long first task — observe
            # one completion before pipelining
            return 1
        if e < CONFIG.pipeline_short_task_ms:
            return max(self.PIPELINE_DEPTH,
                       CONFIG.lease_pipeline_depth_short_task)
        if e < CONFIG.pipeline_medium_task_ms:
            return max(self.PIPELINE_DEPTH,
                       CONFIG.lease_pipeline_depth_medium_task)
        return self.PIPELINE_DEPTH

    def _conn_depth(self, conn: WorkerConn, now: float, depth: int) -> int:
        """A task committed to a busy worker cannot be stolen back. Two
        guards against stranding queued work behind its head-of-line
        task: (a) if that task's FUNCTION has never been observed
        completing in this pool, its duration is unbounded as far as we
        know (the abandoned get-timeout sleeper shape — a fast task
        stacked behind it waits the sleeper out), so no stacking until a
        first completion lands; (b) if the head-of-line has already run
        well past the pool's typical duration (a surprise straggler),
        stop stacking and let _pump lease fresh workers."""
        if conn.dispatch_times:
            if conn.dispatch_fns and \
                    conn.dispatch_fns[0] not in self._fn_ema:
                return 0 if conn.inflight else 1
            limit = max(0.05, ((self._exec_ms_ema or 0.0)
                              * CONFIG.straggler_limit_multiplier) / 1000.0)
            if now - conn.dispatch_times[0] > limit:
                return 0 if conn.inflight else 1
        return depth

    def submit(self, record: TaskRecord) -> None:
        self.pending.append(record)
        # defer one loop tick so a burst of submits drained from the inbox
        # in the same tick lands in pending TOGETHER and rides batched
        # PushTaskBatch frames (the actor path defers its flush the same
        # way); a lone submit still pumps within the same loop iteration
        if not self._pump_scheduled:
            self._pump_scheduled = True
            asyncio.get_running_loop().call_soon(self._scheduled_pump)

    def submit_batch(self, records: List[TaskRecord]) -> None:
        """A submit_many batch lands in pending as ONE extend and one
        deferred pump — the per-record doorbell loop is the exact cost
        submit_many exists to remove."""
        self.pending.extend(records)
        if not self._pump_scheduled:
            self._pump_scheduled = True
            asyncio.get_running_loop().call_soon(self._scheduled_pump)

    def _scheduled_pump(self) -> None:
        self._pump_scheduled = False
        self._pump()

    def _pump(self) -> None:
        # Pipeline up to PIPELINE_DEPTH tasks per leased worker: the worker
        # executes one at a time (its task pool is 1 thread, so the resource
        # grant is respected) while the queued task overlaps RPC transport
        # with execution (reference: direct task submitter pipelining).
        if self.pending:
            depth = self._depth()
            now = time.monotonic()
            ready = sorted(
                (c for c in self.conns
                 if not c.dead and c.inflight < self._conn_depth(c, now, depth)),
                key=lambda c: c.inflight)
            for conn in ready:
                batch: List[TaskRecord] = []
                while self.pending and conn.inflight < self._conn_depth(
                        conn, now, depth):
                    if conn in self.idle:
                        self.idle.remove(conn)
                    conn.inflight += 1
                    batch.append(self.pending.popleft())
                # a burst headed for one worker rides ONE submission frame
                # instead of a frame per task; results stream back per
                # item, so neither latency nor in-frame dependencies
                # couple to the slowest sibling
                if len(batch) == 1:
                    self._dispatch(conn, batch[0])
                elif batch:
                    self._dispatch_batch(conn, batch)
                if not self.pending:
                    break
        want = len(self.pending)
        cap = CONFIG.max_pending_lease_requests_per_scheduling_category
        n = 0
        while (
            want > 0
            and self.inflight_leases < min(cap, want)
            and len(self.conns) + self.inflight_leases < self.MAX_WORKERS
        ):
            self.inflight_leases += 1
            n += 1
            want -= 1
        if n == 0:
            return
        # k leases wanted in one pump ride ONE RequestWorkerLeaseBatch
        # frame (grants stream back per entry); PG leases keep the single
        # path — they resolve their target agent per request
        if n > 1 and not self.pg and CONFIG.lease_batch_enabled:
            spawn_tracked(self._request_lease_batch(n), "lease-request")
        else:
            for _ in range(n):
                spawn_tracked(self._request_lease(), "lease-request")

    async def _resolve_pg_agent(self):
        """Target the agent of the node holding our PG bundle (the reference
        pins PG leases via bundle location, placement_group.py +
        direct_task_transport lease policy). Waits for a PENDING group."""
        w = self.worker
        while True:
            info = await w.head.call("GetPlacementGroup", {"pg_id": self.pg[0]},
                                     timeout=CONFIG.control_rpc_timeout_s)
            if info is None or info.get("state") == "REMOVED":
                raise _PlacementGroupGone(
                    f"placement group {self.pg[0]} removed")
            placement = info.get("placement")
            if placement:
                idx = self.pg[1]
                if idx is None or idx < 0:
                    # bundle_index -1 = any bundle: rotate over the group's
                    # nodes; the agent maps onto a concrete local bundle.
                    self._pg_rr = getattr(self, "_pg_rr", -1) + 1
                    node_id = placement[self._pg_rr % len(placement)]
                else:
                    node_id = placement[idx]
                view = await w.head.call("GetClusterView", {},
                                         timeout=CONFIG.control_rpc_timeout_s)
                node = view.get(node_id)
                if node is None:
                    raise RpcError(f"bundle node {node_id} lost")
                return node["addr"]
            await asyncio.sleep(CONFIG.pg_resolve_poll_s)

    def _lease_payload(self) -> Dict:
        w = self.worker
        return {
            "resources": self.resources,
            "scheduling_strategy": self.strategy,
            "pg": self.pg,
            "owner": w.worker_id.hex(),
            "env_key": self.env_key,
            "container": self.container,
            "conda": self.conda,
            "retriable": self.retriable,
        }

    async def _request_lease(self) -> None:
        w = self.worker
        payload = self._lease_payload()
        try:
            agent_addr = None
            if self.pg:
                agent_addr = await self._resolve_pg_agent()
                client = await w._owner_client(agent_addr)
                # raylint: disable=R6 -- long-poll by design: a lease may
                # queue for minutes under spawn admission; node death fails
                # this call fast via the node-channel fail-fast path
                reply = await client.call(
                    "RequestWorkerLease", {**payload, "spilled_once": True})
            else:
                # raylint: disable=R6 -- long-poll by design (see above)
                reply = await w.agent.call("RequestWorkerLease", payload)
            await self._finish_lease(reply, payload, agent_addr)
        except (_PlacementGroupGone, _RuntimeEnvFailed) as e:
            self._lease_unschedulable(e)
        except Exception:
            await self._lease_failed()

    async def _request_lease_batch(self, n: int) -> None:
        """One RequestWorkerLeaseBatch frame for n leases: the
        agent streams per-entry grants back as LeaseItem pushes (routed
        inline by _on_agent_push_sync) so fast grants wire up while slow
        entries still queue; the closing reply settles stragglers."""
        w = self.worker
        payload = self._lease_payload()
        w._lease_batch_seq += 1
        bid = w._lease_batch_seq
        seen: set = set()

        async def finish_item(reply) -> None:
            try:
                await self._finish_lease(reply, payload, None)
            except (_PlacementGroupGone, _RuntimeEnvFailed) as e:
                self._lease_unschedulable(e)
            except Exception:
                await self._lease_failed()

        def on_item(p: Dict) -> None:
            i = p.get("i")
            if i in seen:
                return
            seen.add(i)
            spawn_tracked(finish_item(p.get("r")), "lease-batch-item")

        w._lease_batches[bid] = on_item
        try:
            # raylint: disable=R6 -- long-poll by design (entries may
            # legitimately queue behind capacity for minutes)
            await w.agent.call("RequestWorkerLeaseBatch",
                               {**payload, "n": n, "b": bid})
        except Exception:
            missing = n - len(seen)
            if missing > 0:
                self.inflight_leases -= missing
                if self.pending:
                    await asyncio.sleep(CONFIG.lease_retry_backoff_s)
                    self._pump()
        finally:
            w._lease_batches.pop(bid, None)

    async def _finish_lease(self, reply, payload: Dict,
                            agent_addr: Optional[Dict]) -> None:
        """Spillback-follow + grant wiring shared by the single and
        batched lease paths. Settles exactly one inflight_leases slot on
        success; raises for the caller's failure accounting."""
        w = self.worker
        hops = 0
        while reply and reply.get("spillback") and \
                hops < CONFIG.lease_spillback_max_hops:
            hops += 1
            target = reply["spillback"]
            agent_addr = target["addr"]
            client = await w._owner_client(agent_addr)
            # raylint: disable=R6 -- long-poll by design (see above)
            reply = await client.call(
                "RequestWorkerLease", {**payload, "spilled_once": True}
            )
        if reply and reply.get("error") == "pg_removed":
            raise _PlacementGroupGone(
                f"placement group {self.pg[0] if self.pg else ''} removed")
        if reply and reply.get("error") == "runtime_env":
            raise _RuntimeEnvFailed(
                reply.get("message", "runtime_env setup failed"))
        grant = (reply or {}).get("grant")
        if not grant:
            raise RpcError("lease request failed")
        conn = WorkerConn(
            grant["lease_id"],
            grant["worker_id"],
            grant["addr"],
            grant["node_id"],
            agent_addr,
        )
        if grant["node_id"] in w._dead_nodes:
            # the node died between grant and now (partition verdict
            # raced the lease reply); don't connect into a zombie
            raise w.node_death_error(grant["node_id"],
                                     "lease granted by dead node")
        conn.assigned_instances = grant.get("assigned_instances", {})
        # stream on the shared per-process session — a leased
        # worker that later becomes an actor reuses the same socket pair
        conn.client = await w._direct_stream(
            conn.addr, label=f"lease-{grant['worker_id'][:8]}",
            node_id=conn.node_id)
        self.conns.append(conn)
        self.inflight_leases -= 1
        conn.idle_since = time.monotonic()
        self.idle.append(conn)
        # A grant can arrive after the queue drained; make sure an unused
        # lease is returned rather than pinning resources forever.
        self._ensure_reaper()
        self._pump()

    def _lease_unschedulable(self, e: Exception) -> None:
        # Unschedulable forever: fail every queued task, don't retry.
        from ray_tpu_torch.runtime_env.runtime_env import RuntimeEnvSetupError

        exc = (RuntimeEnvSetupError(str(e))
               if isinstance(e, _RuntimeEnvFailed)
               else RuntimeError(str(e)))
        self.inflight_leases -= 1
        while self.pending:
            record = self.pending.popleft()
            self.worker._on_task_failure(record, exc, retriable=False)

    async def _lease_failed(self) -> None:
        if os.environ.get("RAY_TPU_TORCH_DEBUG"):
            import traceback

            traceback.print_exc()
        self.inflight_leases -= 1
        if self.pending:
            await asyncio.sleep(CONFIG.lease_retry_backoff_s)
            self._pump()

    def _dispatch(self, conn: WorkerConn, record: TaskRecord) -> None:
        """Send PushTask via the client's write-combined frame queue and
        resolve the reply through a future callback — no per-task coroutine
        (this is the submit→push hot loop; reference keeps it in C++)."""
        if record.cancelled:
            self._after_task(conn)
            return
        if record.spec.trace_ctx is not None:
            _span_since(record, "lease_wait")
        try:
            wire = dict(record.spec.to_wire())  # copy: cached base
            wire["assigned_instances"] = getattr(conn, "assigned_instances", {})
            fut = conn.client.call_future("PushTask", wire)
        except Exception:
            self._on_push_failed(conn, record)
            return
        conn.dispatch_times.append(time.monotonic())
        conn.dispatch_fns.append(record.spec.function_name)
        fut.add_done_callback(
            lambda f: self._on_push_done(conn, record, f))

    def _on_push_done(self, conn: WorkerConn, record: TaskRecord,
                      fut: "asyncio.Future") -> None:
        if conn.dispatch_times:
            conn.dispatch_times.popleft()
        if conn.dispatch_fns:
            conn.dispatch_fns.popleft()
        if fut.cancelled() or fut.exception() is not None:
            self._on_push_failed(conn, record)
            return
        reply = fut.result()
        ms = reply.get("exec_ms") if isinstance(reply, dict) else None
        if ms is not None:
            self._note_exec_ms(record.spec.function_name, ms)
        try:
            self.worker._on_task_reply(record, reply)
        except Exception as e:  # a reply-processing bug must not leak
            # conn.inflight (the lease would wedge) or hang the caller
            import logging

            logging.getLogger("ray_tpu_torch").exception(
                "error processing task reply for %s",
                record.spec.function_name)
            self.worker._on_task_failure(record, e, retriable=False)
        self._after_task(conn)

    def _dispatch_batch(self, conn: WorkerConn,
                        records: List[TaskRecord]) -> None:
        """One submission frame, streamed per-item replies: each BatchItem
        push resolves its record the moment the worker finishes it, so a
        frame can safely mix producers with their dependents and a fast
        task never waits out a slow frame-mate."""
        wires = []
        live = []
        for record in records:
            if record.cancelled:
                self._after_task(conn)
                continue
            if record.spec.trace_ctx is not None:
                _span_since(record, "lease_wait")
            # no per-item copy: assigned_instances is identical for every
            # item on one conn, so it rides the frame ONCE as a batch-level
            # key ("ai") and the executor applies it to each spec
            wires.append(record.spec.to_wire())
            live.append(record)
        if not live:
            return
        client = conn.client
        batches = getattr(client, "_stream_batches", None)
        if batches is None:
            batches = _attach_batch_router(client)
        # channel-scoped (see _ActorState._push_batch)
        bid = client.next_batch_id()
        resolved = [False] * len(live)

        def on_item(i, reply):
            if i is None or not (0 <= i < len(live)) or resolved[i]:
                return
            resolved[i] = True
            if conn.dispatch_times:
                conn.dispatch_times.popleft()
            if conn.dispatch_fns:
                conn.dispatch_fns.popleft()
            record = live[i]
            ms = reply.get("exec_ms") if isinstance(reply, dict) else None
            if ms is not None:
                self._note_exec_ms(record.spec.function_name, ms)
            try:
                if isinstance(reply, dict) and "batch_item_error" in reply:
                    self.worker._on_task_failure(
                        record,
                        RuntimeError("task failed in worker: "
                                     f"{reply['batch_item_error']}"),
                        retriable=False)
                else:
                    self.worker._on_task_reply(record, reply)
            except Exception as e:
                import logging

                logging.getLogger("ray_tpu_torch").exception(
                    "error processing task reply for %s",
                    record.spec.function_name)
                self.worker._on_task_failure(record, e, retriable=False)
            self._after_stream_item(conn)

        if CONFIG.completion_batch_enabled:
            # items from one BatchItems frame (or several frames in one
            # read pass) resolve together via the worker's completion
            # queue — one memory-store/ref-counter pass for the burst
            w = self.worker
            batches[bid] = lambda i, reply: \
                w._completion_enqueue(on_item, i, reply)
        else:
            batches[bid] = on_item
        try:
            fut = client.call_future(
                "PushTaskBatchStream",
                {"b": bid, "specs": wires,
                 "ai": getattr(conn, "assigned_instances", {})})
        except Exception:
            batches.pop(bid, None)
            self._on_batch_failed(conn, live)
            return
        now = time.monotonic()
        conn.dispatch_times.extend([now] * len(live))
        conn.dispatch_fns.extend(r.spec.function_name for r in live)

        def on_final(f):
            batches.pop(bid, None)
            stragglers = [r for r, done in zip(live, resolved) if not done]
            if not stragglers:
                return
            for _ in stragglers:
                if conn.dispatch_times:
                    conn.dispatch_times.popleft()
                if conn.dispatch_fns:
                    conn.dispatch_fns.popleft()
            self._on_batch_failed(conn, stragglers)

        fut.add_done_callback(on_final)

    def _after_stream_item(self, conn: WorkerConn) -> None:
        """Per-item completion: free the pipeline slot; refills coalesce
        into one deferred pump (items from one network frame decrement
        together, then a single pump re-batches)."""
        conn.inflight -= 1
        if self.pending and not conn.dead:
            if not self._pump_scheduled:
                self._pump_scheduled = True
                asyncio.get_running_loop().call_soon(self._scheduled_pump)
        elif conn.inflight == 0 and not conn.dead and conn not in self.idle:
            conn.idle_since = time.monotonic()
            self.idle.append(conn)
            self._ensure_reaper()

    def _push_failure_error(self, conn: WorkerConn,
                            record: TaskRecord) -> Exception:
        """WorkerCrashedError for a lone worker death; NodeDiedError
        (with node_id / incarnation / reason / timeline) when the whole
        node was declared dead — retries still reroute either way, but
        an exhausted retry budget surfaces the true cause."""
        err = self.worker.node_death_error(
            conn.node_id,
            f"in-flight task {record.spec.function_name} failed fast")
        if err is not None:
            return err
        return WorkerCrashedError(
            f"worker died while running {record.spec.function_name}")

    def on_node_removed(self, node_id: str) -> None:
        """Cluster-level death verdict: fail this pool's connections to
        the node NOW. close() fails every pending PushTask future with
        ConnectionLost, which routes through _on_push_failed →
        NodeDiedError-aware retry — no 600 s wait on a partitioned
        socket."""
        for conn in list(self.conns):
            if conn.node_id == node_id and not conn.dead:
                conn.dead = True
                if conn.client is not None:
                    # close() first for the synchronous fail-fast, then
                    # close_soon() so the cancelled read loop is awaited
                    # instead of stranded on the dying loop
                    conn.client.close()
                    conn.client.close_soon()

    def _on_batch_failed(self, conn: WorkerConn,
                         records: List[TaskRecord]) -> None:
        conn.dead = True
        spawn_tracked(self._drop_conn(conn, worker_exited=True),
                      "lease-drop-conn")
        for record in records:
            self.worker._on_task_failure(
                record, self._push_failure_error(conn, record),
                retriable=True,
            )
        self._pump()

    def _on_push_failed(self, conn: WorkerConn, record: TaskRecord) -> None:
        conn.dead = True
        spawn_tracked(self._drop_conn(conn, worker_exited=True),
                      "lease-drop-conn")
        self.worker._on_task_failure(
            record, self._push_failure_error(conn, record),
            retriable=True,
        )
        self._pump()

    def _after_task(self, conn: WorkerConn) -> None:
        conn.inflight -= 1
        if self.pending and not conn.dead:
            if conn.inflight < self._conn_depth(
                    conn, time.monotonic(), self._depth()):
                conn.inflight += 1
                record = self.pending.popleft()
                self._dispatch(conn, record)
            else:
                self._pump()  # stragglers here; spread onto fresh leases
            return
        if conn.inflight == 0 and conn not in self.idle:
            conn.idle_since = time.monotonic()
            self.idle.append(conn)
            self._ensure_reaper()

    def _ensure_reaper(self) -> None:
        if self._reaper is None or self._reaper.done():
            self._reaper = asyncio.get_running_loop().create_task(
                self._reap_idle_loop())

    async def _reap_idle_loop(self) -> None:
        """One periodic sweep per pool instead of one timer task per idle
        transition (the bench churns thousands of those)."""
        while self.idle:
            await asyncio.sleep(self.IDLE_TTL)
            now = time.monotonic()
            for conn in [c for c in self.idle
                         if now - c.idle_since >= self.IDLE_TTL]:
                # _drop_conn awaits: a _pump on the loop may have re-claimed
                # this conn (or a later one in the snapshot) meanwhile
                if conn in self.idle and                         time.monotonic() - conn.idle_since >= self.IDLE_TTL:
                    self.idle.remove(conn)
                    await self._drop_conn(conn)

    async def _drop_conn(self, conn: WorkerConn, worker_exited: bool = False) -> None:
        if conn in self.conns:
            self.conns.remove(conn)
        if conn in self.idle:
            self.idle.remove(conn)
        w = self.worker
        try:
            # a dead node's agent can't take the lease back (the RPC would
            # only stall on a partitioned socket); bounded either way
            if conn.node_id not in w._dead_nodes:
                payload = {"lease_id": conn.lease_id,
                           "worker_id": conn.worker_id,
                           "worker_exiting": worker_exited}
                if conn.agent_addr:
                    client = await w._owner_client(conn.agent_addr)
                    await client.call("ReturnWorker", payload, timeout=10)
                else:
                    await w.agent.call("ReturnWorker", payload, timeout=10)
        except Exception:
            pass
        if conn.client:
            await conn.client.aclose()


class _ActorState:
    """Caller-side actor call pipeline: sequenced, ordered, reconnecting
    (reference: direct_actor_task_submitter.h CoreWorkerDirectActorTaskSubmitter)."""

    # max specs per PushTaskBatch frame: bounds the receiver's reply delay
    # for the batch's first task (execution is serial per actor anyway)
    @property
    def BATCH_MAX(self) -> int:
        return CONFIG.actor_call_batch_max

    def __init__(self, actor_id: ActorID):
        self.actor_id = actor_id
        self.state = "PENDING_CREATION"
        self.addr: Optional[Dict] = None
        self.client: Optional[AsyncRpcClient] = None
        self._seq = _Counter()
        self.queue: deque = deque()
        self.death_cause = ""
        # structured provenance from the GCS actor view (node_id,
        # incarnation, reason, timeline) — rides every ActorDiedError
        self.death_context: Optional[Dict] = None
        self._connecting = False
        self._flush_scheduled = False
        # in-flight records awaiting retry after a broken push; flushed
        # onto the FRONT of the queue once per tick so a broken batch
        # re-lands in original submission order
        self._retry_buf: List[TaskRecord] = []
        self._retry_flush_scheduled = False
        # observed execution-time EMA (ms), fed by reply exec_ms: batching
        # is only worth its reply-delay cost for SHORT tasks (a batch's
        # first result arrives after the whole frame executes serially)
        self._exec_ms_ema: Optional[float] = None

    def next_seq(self) -> int:
        return self._seq.next()

    def update(self, view: Dict, worker: Worker) -> None:
        old_state = self.state
        new_state = view.get("state", self.state)
        if new_state == "PENDING_CREATION" and old_state != "PENDING_CREATION":
            return  # stale tracker registration must not regress a live state
        self.state = new_state
        self.death_cause = view.get("death_cause", "") or self.death_cause
        self.death_context = view.get("death_context") or self.death_context
        addr = view.get("addr")
        if self.state == "ALIVE" and addr:
            self.addr = addr
            worker._loop_call(self._flush, worker)
        elif self.state in ("RESTARTING",):
            if self.client:
                self.client.close_soon()
                self.client = None
            self.addr = None
        elif self.state == "DEAD" and old_state != "DEAD":
            if self.client:
                self.client.close_soon()
                self.client = None
            worker._loop_call(self._fail_all, worker)

    def _died_error(self, reason: str = "") -> ActorDiedError:
        ctx = self.death_context or {}
        return ActorDiedError(
            self.actor_id.hex(),
            reason or self.death_cause or "actor died",
            node_id=ctx.get("node_id", ""),
            incarnation=ctx.get("incarnation", 0),
            timeline=ctx.get("timeline") or [])

    def enqueue(self, worker: Worker, record: TaskRecord) -> None:
        if self.state == "DEAD":
            worker._on_task_failure(record, self._died_error(),
                                    retriable=False)
            return
        self.queue.append(record)
        # defer the flush one loop tick: a burst of enqueues drained from
        # the submission inbox in one callback then leaves as ONE
        # PushTaskBatch frame instead of a frame per call (end-to-end
        # batching; reference: direct_actor_task_submitter.h's
        # SendPendingTasks draining the whole queue per wakeup)
        if not self._flush_scheduled:
            self._flush_scheduled = True
            asyncio.get_running_loop().call_soon(
                self._scheduled_flush, worker)

    def enqueue_batch(self, worker: Worker, records: List[TaskRecord]) -> None:
        """A submit_actor_tasks_many group lands as one extend + one
        deferred flush (vs. a doorbell per call), then leaves as one
        PushTaskBatchStream frame per BATCH_MAX window."""
        if self.state == "DEAD":
            err = self._died_error()
            for r in records:
                worker._on_task_failure(r, err, retriable=False)
            return
        self.queue.extend(records)
        if not self._flush_scheduled:
            self._flush_scheduled = True
            asyncio.get_running_loop().call_soon(
                self._scheduled_flush, worker)

    def _scheduled_flush(self, worker: Worker) -> None:
        self._flush_scheduled = False
        self._flush(worker)

    def _flush(self, worker: Worker) -> None:
        if self.state != "ALIVE" or self.addr is None or self._connecting:
            return
        if self.client is None or not self.client.connected:
            self._connecting = True
            spawn_tracked(self._connect_then_flush(worker),
                          "actor-connect-flush")
            return
        while self.queue:
            cap = self._batch_cap()
            if len(self.queue) == 1 or cap <= 1:
                self._push_nowait(worker, self.queue.popleft())
            else:
                n = min(len(self.queue), cap)
                self._push_batch(worker,
                                 [self.queue.popleft() for _ in range(n)])

    def _batch_cap(self) -> int:
        """Frame size by observed task duration: a batch reply lands only
        after the LAST task in the frame executes, so long tasks ship
        individually (same duration-adaptive idea as the lease pools'
        pipelining depth)."""
        ema = self._exec_ms_ema
        if ema is None:
            return 8          # unknown: modest batch until measured
        if ema < CONFIG.actor_batch_short_ms:
            return self.BATCH_MAX
        if ema < CONFIG.actor_batch_medium_ms:
            return 16
        return 1

    def _note_exec_ms(self, reply) -> None:
        if isinstance(reply, dict) and "exec_ms" in reply:
            ms = float(reply["exec_ms"])
            ema = self._exec_ms_ema
            self._exec_ms_ema = ms if ema is None else 0.8 * ema + 0.2 * ms

    async def _connect_then_flush(self, worker: Worker) -> None:
        addr = self.addr
        try:
            # a stream on the shared per-process session:
            # same-node actors ride the shm lane, and closing this
            # actor's stream later cannot tear down its siblings'
            self.client = await worker._direct_stream(
                addr, label=f"actor-{self.actor_id.hex()[:8]}")
        except Exception:
            self.client = None
            # The addr may be stale (actor died) or freshly updated while we
            # were connecting; back off and re-drive the flush so queued calls
            # can't wedge.
            await asyncio.sleep(CONFIG.actor_reconnect_backoff_s)
        finally:
            self._connecting = False
        if self.queue:
            self._flush(worker)

    def _push_nowait(self, worker: Worker, record: TaskRecord) -> None:
        """Pipelined, sequenced push over the write-combined client; the
        receiver orders by seq (reference: direct_actor_task_submitter.h)."""
        if record.spec.trace_ctx is not None:
            _span_since(record, "enqueue_wait")
        try:
            fut = self.client.call_future("PushTask", record.spec.to_wire())
        except Exception:
            self._on_push_broken(worker, record)
            return
        fut.add_done_callback(
            lambda f: self._on_push_reply(worker, record, f))

    def _push_batch(self, worker: Worker, records: List[TaskRecord]) -> None:
        """Many sequenced calls in ONE frame; the worker executes them in
        order (its serial per-actor discipline) and STREAMS each result
        back as it lands — a slow method doesn't gate its frame-mates'
        callers, and a call whose arg is a frame-mate's return resolves
        instead of deadlocking on the frame reply."""
        client = self.client
        batches = getattr(client, "_stream_batches", None)
        if batches is None:
            batches = _attach_batch_router(client)
        # channel-scoped id: sibling streams on a shared mux session
        # route BatchItems through ONE session router, so a per-actor
        # counter would collide across actors
        bid = client.next_batch_id()
        resolved = [False] * len(records)

        def on_item(i, reply):
            if i is None or not (0 <= i < len(records)) or resolved[i]:
                return
            resolved[i] = True
            record = records[i]
            self._note_exec_ms(reply)
            if isinstance(reply, dict) and "batch_item_error" in reply:
                # one item failed at the handler level; the rest of the
                # frame is fine (see handle_push_task_batch_stream)
                worker._on_task_failure(
                    record,
                    RuntimeError(
                        f"actor task failed in worker: "
                        f"{reply['batch_item_error']}"),
                    retriable=False)
                return
            try:
                worker._on_task_reply(record, reply)
            except Exception as e:
                import logging

                logging.getLogger("ray_tpu_torch").exception(
                    "error processing actor reply for %s",
                    record.spec.function_name)
                worker._on_task_failure(record, e, retriable=False)

        if CONFIG.completion_batch_enabled:
            batches[bid] = lambda i, reply: \
                worker._completion_enqueue(on_item, i, reply)
        else:
            batches[bid] = on_item
        for r in records:
            if r.spec.trace_ctx is not None:
                _span_since(r, "enqueue_wait")
        try:
            fut = client.call_future(
                "PushTaskBatchStream",
                {"b": bid, "specs": [r.spec.to_wire() for r in records]})
        except Exception:
            batches.pop(bid, None)
            for record in records:
                self._on_push_broken(worker, record)
            return

        def on_final(f):
            batches.pop(bid, None)
            for record, done in zip(records, resolved):
                if not done:
                    self._on_push_broken(worker, record)

        fut.add_done_callback(on_final)

    def _on_push_reply(self, worker: Worker, record: TaskRecord,
                       fut: "asyncio.Future") -> None:
        if not fut.cancelled() and fut.exception() is None:
            try:
                self._note_exec_ms(fut.result())
                worker._on_task_reply(record, fut.result())
            except Exception as e:
                import logging

                logging.getLogger("ray_tpu_torch").exception(
                    "error processing actor reply for %s",
                    record.spec.function_name)
                worker._on_task_failure(record, e, retriable=False)
        else:
            self._on_push_broken(worker, record)

    def _on_push_broken(self, worker: Worker, record: TaskRecord) -> None:
        # Connection broke with the task in flight. It MAY have executed:
        # the default is fail-don't-resend; max_task_retries opts in to
        # at-least-once resubmission after the actor restarts (reference
        # actor.py max_task_retries semantics). Queued-but-unsent tasks
        # stay queued for the restarted actor either way.
        if self.state == "ALIVE":
            self.state = "RESTARTING"
        spec = record.spec
        if spec.max_retries > record.attempts and not record.cancelled \
                and record.streaming_gen is None and self.state != "DEAD":
            record.attempts += 1
            self._retry_buf.append(record)
            worker._record_task_event(spec, "RETRYING")
            if not self._retry_flush_scheduled:
                self._retry_flush_scheduled = True
                asyncio.get_running_loop().call_soon(
                    self._flush_retries, worker)
            return
        worker._on_task_failure(
            record,
            self._died_error(
                self.death_cause or "actor died while this call was in flight"),
            retriable=False,
        )

    def _flush_retries(self, worker: Worker) -> None:
        """Splice buffered retries onto the queue front in their original
        submission order (per-record appendleft would reverse a broken
        batch). A death that landed while buffering fails them instead —
        a DEAD actor's queue is never drained again."""
        self._retry_flush_scheduled = False
        buf, self._retry_buf = self._retry_buf, []
        if self.state == "DEAD":
            for record in buf:
                worker._on_task_failure(record, self._died_error(),
                                        retriable=False)
            return
        self.queue.extendleft(reversed(buf))

    def _fail_all(self, worker: Worker) -> None:
        # late retries must die with the actor, not linger in the buffer
        self.queue.extendleft(reversed(self._retry_buf))
        self._retry_buf = []
        while self.queue:
            record = self.queue.popleft()
            worker._on_task_failure(record, self._died_error(),
                                    retriable=False)
