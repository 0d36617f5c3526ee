# Ported from ray_tpu/util/collective/collective_group/store.py (ray_tpu -> ray_tpu_torch; the docstring names the NCCL backend).
"""Named rendezvous store actor for host-side collectives.

Reference analog: python/ray/util/collective/collective_group/gloo_util.py:29-98
(the named-actor Store used for gloo rendezvous). The store carries
rendezvous state and INLINE payloads only for metadata-sized tensors;
bulk tensors cross as ObjectRefs whose bytes move worker<->worker through
the object plane (cpu_group._boxed), so this actor never relays
O(members x bytes). With the NCCL backend, bulk traffic rides the cards'
links and this store only ever sees the group's rendezvous address.

All methods are non-blocking so a ``max_concurrency=1`` actor can serve every
member; callers poll.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional


class CollectiveStore:
    """One instance per group, named ``_collective_store:{group_name}``."""

    def __init__(self):
        # op_key -> {rank: payload}
        self._parts: Dict[str, Dict[int, Any]] = {}
        # op_key -> number of members that already read the completed set
        self._reads: Dict[str, int] = {}
        # op_key -> number of members that finished fetching boxed refs
        self._confirms: Dict[str, int] = {}
        # op_key / p2p key -> creation time (orphan TTL sweeps)
        self._born: Dict[str, float] = {}
        self._p2p: Dict[str, Any] = {}
        self._members: Dict[int, float] = {}

    def register(self, rank: int) -> int:
        self._members[rank] = time.time()
        return len(self._members)

    def num_members(self) -> int:
        return len(self._members)

    def deregister(self, rank: int) -> int:
        self._members.pop(rank, None)
        return len(self._members)

    # entries older than this are orphans (a member died/timed out and
    # its confirms will never arrive): drop them so their ObjectRefs stop
    # pinning bulk payloads forever
    ORPHAN_TTL_S = 600.0

    def _sweep_orphans(self) -> None:
        now = time.time()
        for key, born in list(self._born.items()):
            if now - born > self.ORPHAN_TTL_S:
                self._parts.pop(key, None)
                self._reads.pop(key, None)
                self._confirms.pop(key, None)
                self._p2p.pop(key, None)
                del self._born[key]

    def contribute(self, op_key: str, rank: int, payload: Any) -> int:
        self._sweep_orphans()
        parts = self._parts.setdefault(op_key, {})
        self._born.setdefault(op_key, time.time())
        parts[rank] = payload
        return len(parts)

    def collect(self, op_key: str, world_size: int) -> Optional[List[Any]]:
        """Return payloads ordered by rank once all members contributed.

        Inline entries are garbage-collected after ``world_size``
        successful reads. Entries holding ObjectRefs (bulk payloads riding
        the object plane) are kept until every member ``confirm``s its
        fetch — this actor's copies are what pin the objects while slower
        members are still pulling the bytes.
        """
        parts = self._parts.get(op_key)
        if parts is None or len(parts) < world_size:
            return None
        out = [parts[r] for r in range(world_size)]
        boxed_refs = any(isinstance(p, tuple) and p and p[0] == "r"
                         for p in out)
        reads = self._reads.get(op_key, 0) + 1
        if reads >= world_size and not boxed_refs:
            del self._parts[op_key]
            self._reads.pop(op_key, None)
        else:
            self._reads[op_key] = reads
        return out

    def confirm(self, op_key: str, world_size: int) -> None:
        """A member finished FETCHING a boxed entry's payloads; the entry
        (and the refs pinning the objects) drops after the last one."""
        confirms = self._confirms.get(op_key, 0) + 1
        if confirms >= world_size:
            self._parts.pop(op_key, None)
            self._reads.pop(op_key, None)
            self._confirms.pop(op_key, None)
            self._born.pop(op_key, None)
        else:
            self._confirms[op_key] = confirms

    def put_p2p(self, key: str, payload: Any) -> None:
        self._sweep_orphans()
        self._p2p[key] = payload
        self._born.setdefault(key, time.time())

    def take_p2p(self, key: str) -> Optional[List[Any]]:
        """Boxed result ([payload] or None) so None payloads round-trip.

        Inline ("v") entries pop destructively — one round trip, the
        common metadata-sized path. Object-plane ("r") entries stay until
        confirm_p2p (their ref pins the payload while the receiver is
        still fetching the bytes)."""
        boxed = self._p2p.get(key)
        if boxed is None:
            return None
        if isinstance(boxed, tuple) and boxed and boxed[0] == "v":
            self._p2p.pop(key, None)
            self._born.pop(key, None)
        return [boxed]

    def confirm_p2p(self, key: str) -> None:
        self._p2p.pop(key, None)
        self._born.pop(key, None)

    def op_done(self, op_key: str) -> bool:
        """True once the entry is fully confirmed and dropped."""
        return op_key not in self._parts

    def p2p_absent(self, keys: List[str]) -> List[str]:
        """Which of these p2p entries are gone (receiver confirmed)."""
        return [k for k in keys if k not in self._p2p]
