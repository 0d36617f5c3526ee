# Copied from ray_tpu/scripts/cli.py (ray_tpu -> ray_tpu_torch, RAY_TPU_ -> RAY_TPU_TORCH_).
"""CLI (reference: python/ray/scripts/scripts.py — ``ray
start/stop/status/memory/timeline/summary`` via click; argparse here).

``python -m ray_tpu_torch.scripts.cli start --head`` daemonizes a head node
whose address lands in ``ray_tpu_torch_current_head`` under the temporary
directory (``tempfile.gettempdir()``, so ``TMPDIR`` keeps two checkouts'
heads apart, as it does their session roots); workers join with
``start --address host:port``. The node finds the host's GPUs as
``ray_tpu_torch.init`` does. ``up`` and ``down`` raise ``not_ported``: the
port has no copy of the autoscaler's launcher yet.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

ADDR_FILE = os.path.join(tempfile.gettempdir(), "ray_tpu_torch_current_head")
PID_FILE = os.path.join(tempfile.gettempdir(), "ray_tpu_torch_node_pids")


def _record_pid(pid: int) -> None:
    pids = []
    if os.path.exists(PID_FILE):
        with open(PID_FILE) as f:
            pids = json.load(f)
    pids.append(pid)
    with open(PID_FILE, "w") as f:
        json.dump(pids, f)


def cmd_start(args) -> int:
    runner = (
        "import json, signal, sys, time\n"
        "import ray_tpu_torch\n"
        "from ray_tpu_torch._private.node import Node\n"
        f"head = {args.head}\n"
        f"addr = {args.address!r}\n"
        f"res = json.loads({args.resources!r}) if {args.resources!r} else None\n"
        f"num_cpus = {args.num_cpus!r}\n"
        "if num_cpus is not None:\n"
        "    res = dict(res or {}); res['CPU'] = float(num_cpus)\n"
        "if head:\n"
        f"    node = Node(head=True, head_port={args.port}, resources=res)\n"
        "else:\n"
        "    host, _, port = addr.partition(':')\n"
        "    node = Node(head=False, head_host=host, head_port=int(port),"
        " resources=res)\n"
        "node.start()\n"
        "if head:\n"
        f"    open({ADDR_FILE!r}, 'w').write("
        "f'{node.head_host}:{node.head_port}')\n"
        "print('NODE_READY', node.session_dir, flush=True)\n"
        "def _stop(*a):\n"
        "    node.stop(cleanup_session=head)\n"
        "    sys.exit(0)\n"
        "signal.signal(signal.SIGTERM, _stop)\n"
        "while True:\n"
        "    time.sleep(3600)\n"
    )
    proc = subprocess.Popen(
        [sys.executable, "-u", "-c", runner],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if line.startswith("NODE_READY"):
            _record_pid(proc.pid)
            print(f"node started (pid {proc.pid}): {line.split()[1]}")
            if args.head:
                with open(ADDR_FILE) as f:
                    print(f"head address: {f.read()}")
            return 0
        if proc.poll() is not None:
            print("node failed to start:\n" + line +
                  (proc.stdout.read() or ""))
            return 1
    proc.kill()
    print("node start timed out")
    return 1


def cmd_up(args) -> int:
    """Launch head + workers over SSH (or locally) from a cluster config
    (reference: autoscaler/_private/commands.py create_or_update_cluster).
    The port has no copy of the autoscaler's launcher yet."""
    from ray_tpu_torch._private.not_ported import not_ported

    raise not_ported("the autoscaler's cluster launcher (`cli up`)")


def cmd_down(args) -> int:
    from ray_tpu_torch._private.not_ported import not_ported

    raise not_ported("the autoscaler's cluster launcher (`cli down`)")


def cmd_stop(args) -> int:
    from ray_tpu_torch._private import lifecycle

    signalled = []
    if os.path.exists(PID_FILE):
        with open(PID_FILE) as f:
            pids = json.load(f)
        for pid in pids:
            try:
                os.killpg(os.getpgid(pid), signal.SIGTERM)
                signalled.append(pid)
            except (ProcessLookupError, PermissionError):
                pass
        os.remove(PID_FILE)
    for f in (ADDR_FILE,):
        if os.path.exists(f):
            os.remove(f)
    # wait (bounded) for the signalled runners to finish their graceful
    # node.stop — returning while their teardown is in flight would make
    # the post-stop `status` race its own cluster
    deadline = time.monotonic() + 15
    pending = list(signalled)
    while pending and time.monotonic() < deadline:
        pending = [p for p in pending if lifecycle._pid_alive(p)]
        if pending:
            time.sleep(0.1)
    for pid in pending:
        try:
            os.killpg(os.getpgid(pid), signal.SIGKILL)
        except (ProcessLookupError, PermissionError, OSError):
            pass
    print(f"stopped {len(signalled)} node(s)")
    # sweep sessions: with --all, kill live registered daemons too
    # (escalating SIGTERM→SIGKILL); otherwise just unlink session dirs
    # whose pids are all dead so their shm segments are reclaimed
    removed = lifecycle.gc_stale_sessions(
        kill_live=getattr(args, "all", False))
    print(f"reaped {len(removed)} session(s)")
    for path in removed:
        print(f"  {path}")
    return 0


def _connect():
    import ray_tpu_torch

    if ray_tpu_torch.is_initialized():
        return ray_tpu_torch
    if not os.path.exists(ADDR_FILE):
        print("no running head (start one with: "
              "python -m ray_tpu_torch.scripts.cli start --head)")
        sys.exit(1)
    with open(ADDR_FILE) as f:
        ray_tpu_torch.init(address=f.read().strip())
    return ray_tpu_torch


def cmd_status(args) -> int:
    # session lifecycle view first: it needs no running head, and "zero
    # live sessions" is the leak-gate signal benches/CI assert on
    from ray_tpu_torch._private import lifecycle

    sessions = lifecycle.list_sessions()
    print(lifecycle.format_sessions(sessions))
    live = sum(1 for s in sessions if s["live"])
    print(f"\nlive sessions: {live}")
    if not os.path.exists(ADDR_FILE):
        import ray_tpu_torch as _rt

        if not _rt.is_initialized():
            return 0
    try:
        ray_tpu_torch = _connect()
        total = ray_tpu_torch.cluster_resources()
        avail = ray_tpu_torch.available_resources()
    except SystemExit:
        raise
    except Exception as e:
        # a stale ADDR_FILE (runner SIGKILL'd, machine rebooted) must not
        # turn the lifecycle view into a traceback — that headless view
        # is the whole point of `status` after a crash
        print(f"\n(head at {ADDR_FILE} unreachable: {type(e).__name__})")
        return 0
    print("\nNode status")
    print("-" * 40)
    for n in ray_tpu_torch.nodes():
        state = "ALIVE" if n["alive"] else "DEAD"
        print(f"  {n['node_id'][:12]} {state}")
    print("\nResources")
    print("-" * 40)
    for k in sorted(total):
        used = total[k] - avail.get(k, 0.0)
        print(f"  {used:g}/{total[k]:g} {k}")
    _print_head_status()
    _print_events()
    _print_object_plane()
    _print_data_plane()
    _print_data_pipelines()
    _print_worker_pool()
    _print_direct_call_plane()
    return 0


def _print_object_plane() -> None:
    """Object ownership rollup: per-node store bytes by tier,
    cluster ref-table totals, and the leak watchdog's verdict."""
    try:
        from ray_tpu_torch._private import worker as worker_mod

        w = worker_mod.global_worker
        st = w.head_call("ObjectSummary", {"group_by": "node"}, timeout=15)
    except Exception:
        return  # older head without the RPC, or a head mid-bounce
    nodes = st.get("nodes") or {}
    if not nodes:
        return
    print("\nObject plane")
    print("-" * 40)
    total_refs: dict = {}
    suspects = 0
    for node_id, nd in sorted(nodes.items()):
        if nd.get("error"):
            print(f"  {str(node_id)[:12]}: unreachable")
            continue
        tiers = nd.get("tiers") or {}
        store = nd.get("store") or {}
        suspects += len(nd.get("leak_suspects") or [])
        g = (st.get("groups") or {}).get(node_id) or {}
        for k, v in (g.get("refs") or {}).items():
            total_refs[k] = total_refs.get(k, 0) + v
        print(f"  {str(node_id)[:12]}: {_fmt_bytes(store.get('used', 0))}"
              f"/{_fmt_bytes(store.get('capacity', 0))} used   "
              f"tiers shm {tiers.get('shm_objects', 0)} / "
              f"disk {tiers.get('disk_objects', 0)} / "
              f"remote {tiers.get('remote_objects', 0)}")
    print(f"  refs: {total_refs.get('owned', 0)} owned, "
          f"{total_refs.get('borrowed', 0)} borrowed, "
          f"{total_refs.get('task_pins', 0)} task-pinned   "
          f"leak suspects {suspects}")


def _print_head_status() -> None:
    """Head-plane durability view: incarnation, uptime, WAL health, and
    what the last recovery reconciled dead."""
    try:
        from ray_tpu_torch._private import worker as worker_mod

        w = worker_mod.global_worker
        # explicit timeout caps the outage-queue budget too: status
        # against a down head answers in ~3s, not gcs_outage_queue_s
        st = w.head_call("GetHeadStatus", {}, timeout=3)
    except Exception:
        return  # older head without the RPC, or a head mid-bounce
    print("\nHead plane")
    print("-" * 40)
    print(f"  incarnation {st.get('incarnation', 1)}   "
          f"uptime {st.get('uptime_s', 0):.0f}s   "
          f"persist {st.get('persist') or '(memory only)'}")
    wal = st.get("wal")
    if wal:
        print(f"  WAL {wal['size_bytes']} B, seq {wal['seq']}, "
              f"last fsync {wal['last_fsync_age_s']:.1f}s ago, "
              f"{wal['fsyncs']} fsyncs")
    rec = st.get("last_recovery") or {}
    if rec:
        status = "closed" if rec.get("completed") else "open"
        print(f"  last recovery: restored {rec.get('restored_nodes', 0)} "
              f"nodes / {rec.get('restored_actors', 0)} actors / "
              f"{rec.get('restored_jobs', 0)} jobs; "
              f"reconciled dead {rec.get('reconciled_dead', 0)} "
              f"(window {status})")
    recv = st.get("recovering") or {}
    if any(recv.values()):
        print(f"  still recovering: {recv.get('nodes', 0)} nodes, "
              f"{recv.get('actors', 0)} actors, "
              f"{recv.get('jobs', 0)} jobs")


def _print_events() -> None:
    """Flight-recorder health: head ring occupancy plus
    per-node recorded/clipped/flushed counters."""
    try:
        from ray_tpu_torch._private import worker as worker_mod

        w = worker_mod.global_worker
        st = w.head_call("GetEventStats", {}, timeout=3)
    except Exception:
        return  # older head without the RPC, or a head mid-bounce
    head = st.get("head") or {}
    nodes = st.get("nodes") or {}
    print("\nEvents")
    print("-" * 40)
    print(f"  head ring: {head.get('task_events_buffered', 0)} task events"
          f" / {head.get('spans_buffered', 0)} spans buffered"
          f" ({head.get('spans_dropped', 0)} dropped)")
    if not nodes:
        print("  (no flight-recorder flushes — task_event_sample_rate=0?)")
    for node_id, n in sorted(nodes.items()):
        print(f"  {str(node_id)[:12]}: recorded {n.get('recorded', 0)} "
              f"(clipped {n.get('clipped', 0)}) / flushed "
              f"{n.get('spans', 0)} spans + {n.get('events', 0)} events "
              f"in {n.get('flushes', 0)} flushes "
              f"({n.get('rings', 0)} rings, last "
              f"{n.get('last_flush_age_s', 0)}s ago)")


def _print_data_plane() -> None:
    """Device object plane view: this node's zero-copy puts,
    pull/relay counters and spill tiers, plus the head's broadcast-tree
    registry."""
    try:
        from ray_tpu_torch._private import worker as worker_mod

        w = worker_mod.global_worker
        stats = w._acall(w.agent.call("GetPullStats", {}, timeout=3),
                         timeout=5)
    except Exception:
        return  # older agent without the RPC, or headless
    print("\nData plane (this node)")
    print("-" * 40)
    print(f"  zero-copy puts {stats.get('zero_copy_puts', 0)}   "
          f"pulls ok {stats.get('transfers_ok', 0)}   "
          f"chunks served {stats.get('chunks_served', 0)}")
    print(f"  bcast: depth {stats.get('bcast_tree_depth', 0)}, "
          f"tree pulls {stats.get('bcast_tree_pulls', 0)}, "
          f"relayed {stats.get('bcast_relay_bytes', 0)} B, "
          f"reparents {stats.get('bcast_reparents', 0)}, "
          f"fallbacks {stats.get('bcast_fallbacks', 0)}")
    spill = stats.get("spill") or {}
    if spill:
        print(f"  spill tiers: shm {spill.get('shm_objects', 0)} / "
              f"disk {spill.get('disk_objects', 0)} "
              f"({spill.get('disk_bytes', 0)} B) / "
              f"remote {spill.get('remote_objects', 0)}"
              f"  [restores {spill.get('num_restores', 0)}, "
              f"demotions {spill.get('num_remote_demotions', 0)}]")
    try:
        bs = w.head_call("BcastStats", {}, timeout=3)
        if bs and bs.get("trees"):
            print(f"  head trees: {bs['trees']} active, "
                  f"{bs.get('joins_total', 0)} joins, "
                  f"{bs.get('reparents_total', 0)} reparents")
    except Exception:
        pass


def _print_data_pipelines() -> None:
    """Streaming-shuffle / pipeline counters of the most recent Dataset
    execution: drivers publish ExecutorStats to the head KV
    (``__data_stats__:``), so status works from any process."""
    try:
        import json as _json

        from ray_tpu_torch.experimental.internal_kv import (
            _internal_kv_get, _internal_kv_list)

        keys = sorted(_internal_kv_list(b"__data_stats__:"))
        if not keys:
            return
        st = _json.loads(_internal_kv_get(keys[-1]))
    except Exception:
        return
    print("\nData pipelines (last run)")
    print("-" * 40)
    print(f"  wall {st.get('wall_s', 0):.2f}s   "
          f"scheduler iters {st.get('loop_iters', 0)} "
          f"({st.get('idle_waits', 0)} idle waits)   "
          f"consumer stall {st.get('consumer_stall_s', 0):.3f}s over "
          f"{st.get('blocks_consumed', 0)} blocks")
    for op in st.get("ops", []):
        ex = op.get("extra") or {}
        if "shuffle_maps" not in ex:
            continue
        print(f"  shuffle {op.get('name')}: "
              f"{ex.get('shuffle_maps', 0)} maps -> "
              f"{ex.get('shuffle_reducers', 0)} reducers, "
              f"{ex.get('shuffle_shard_bytes', 0)} shard B "
              f"(peak in-flight {ex.get('shuffle_inflight_peak_bytes', 0)})")
        print(f"    stall fraction "
              f"{ex.get('shuffle_stall_fraction', 0):.2f}, "
              f"overlapped={ex.get('shuffle_reduce_overlapped_maps')}, "
              f"map re-execs {ex.get('shuffle_map_reexecs', 0)}, "
              f"reduce retries {ex.get('shuffle_reduce_retries', 0)}")


def _print_direct_call_plane() -> None:
    """Multiplexed direct-call plane view: this process's mux
    sessions/streams and shm-lane counters (each process keeps its own —
    the numbers here are the status driver's, plus the node agent's
    demand-paged pool view below)."""
    try:
        from ray_tpu_torch._private import worker as worker_mod
        from ray_tpu_torch._private.mux import MUX_STATS
        from ray_tpu_torch._private.shm_rpc import SHM_STATS

        w = worker_mod.global_worker
        sessions = len(w._mux_pool._sessions)
        streams = w._mux_pool.total_streams()
        shm_sessions = w._mux_pool.shm_sessions()
    except Exception:
        return
    print("\nDirect-call plane (this process)")
    print("-" * 40)
    print(f"  mux sessions {sessions} ({shm_sessions} shm-attached)   "
          f"streams {streams}   "
          f"opened {MUX_STATS['streams_opened']} / "
          f"closed {MUX_STATS['streams_closed']}")
    print(f"  shm frames out {SHM_STATS['calls_out']} "
          f"({SHM_STATS['bytes_out']} B) / in {SHM_STATS['frames_in']} "
          f"({SHM_STATS['bytes_in']} B)")
    print(f"  fallbacks: oversize {SHM_STATS['fallback_oversize']}, "
          f"ring-full {SHM_STATS['fallback_ring_full']}   "
          f"attach ok {SHM_STATS['attach_ok']} / "
          f"declined {SHM_STATS['attach_declined']}   "
          f"order-gap flushes {SHM_STATS['order_gap_flushes']}")


def _fmt_hist(hist) -> str:
    if not hist:
        return "-"
    def key(k):
        return int(str(k).rstrip("+"))
    return " ".join(f"{k}:{hist[k]}" for k in sorted(hist, key=key))


def _print_worker_pool() -> None:
    """Warm worker pool + batched control-RPC view: pool
    level vs target, hit ratio of actor starts served warm, and the
    lease/registration batch-size histograms."""
    try:
        from ray_tpu_torch._private import worker as worker_mod

        w = worker_mod.global_worker
        st = w._acall(w.agent.call("GetWorkerPoolStats", {}, timeout=3),
                      timeout=5)
    except Exception:
        return  # older agent without the RPC, or headless
    print("\nWorker pool (this node)")
    print("-" * 40)
    hits, misses = st.get("hits", 0), st.get("misses", 0)
    demand = st.get("demand_hits", 0)
    served = hits + demand
    ratio = served / (served + misses) if served + misses else 0.0
    print(f"  warm {st.get('warm', 0)}/{st.get('warm_target', 0)}   "
          f"idle {st.get('idle', 0)}   workers {st.get('workers', 0)}   "
          f"starting {st.get('starting', 0)}   "
          f"waiters {st.get('waiters', 0)}")
    print(f"  actor starts: {hits} warm hits + {demand} demand-paged / "
          f"{misses} cold forks (hit ratio {ratio:.0%})   "
          f"refills {st.get('refills', 0)}   "
          f"ttl-reaped {st.get('reaped', 0)}")
    print(f"  lease batch sizes: {_fmt_hist(st.get('lease_batch_hist'))}")
    print(f"  ready batch sizes: {_fmt_hist(st.get('ready_batch_hist'))}")


def cmd_list(args) -> int:
    from ray_tpu_torch.util import state as state_api

    _connect()
    fn = {
        "actors": state_api.list_actors,
        "nodes": state_api.list_nodes,
        "tasks": state_api.list_tasks,
        "placement-groups": state_api.list_placement_groups,
        "jobs": state_api.list_jobs,
        "workers": state_api.list_workers,
        "objects": state_api.list_objects,
    }[args.resource]
    print(json.dumps(fn(), indent=1, default=str))
    return 0


def cmd_summary(args) -> int:
    from ray_tpu_torch.util import state as state_api

    _connect()
    fn = {"tasks": state_api.summarize_tasks,
          "actors": state_api.summarize_actors,
          "objects": state_api.summarize_objects}[args.resource]
    print(json.dumps(fn(), indent=1))
    return 0


def cmd_timeline(args) -> int:
    if getattr(args, "session", ""):
        # post-mortem mode: no cluster needed — parse the crash-durable
        # ring files straight off the session dir (DaemonKiller / kill -9
        # debugging: the rings of dead processes are still there)
        from ray_tpu_torch._private.events import recover_session, to_chrome_trace

        rings = recover_session(args.session)
        spans = [sp for ring in rings for sp in ring["spans"]]
        events = to_chrome_trace(spans)
        src = f"{len(rings)} ring file(s)"
    else:
        ray_tpu_torch = _connect()
        events = ray_tpu_torch.timeline()
        src = "head"
    path = args.output or os.path.join(
        tempfile.gettempdir(),
        f"ray_tpu_torch_timeline_{int(time.time())}.json")
    with open(path, "w") as f:
        json.dump(events, f)
    print(f"wrote {len(events)} events ({src}) to {path} "
          "(open in chrome://tracing or Perfetto)")
    return 0


def cmd_trace(args) -> int:
    """Span tree of one task across driver/agent/worker:
    resolves the task id (hex prefix) against the head's span ring and
    prints every span sharing its trace, nested by parent."""
    from ray_tpu_torch._private.events import format_trace_tree

    ray_tpu_torch = _connect()
    from ray_tpu_torch._private import worker as worker_mod

    w = worker_mod.global_worker
    w.flush_task_events(wait=True)
    hits = w.head_call("ListSpans", {"task": args.task_id, "limit": 1000},
                       timeout=10)
    if not hits:
        print(f"no spans for task {args.task_id!r} (is "
              "task_event_sample_rate > 0, and did the task run "
              "recently?)")
        return 1
    traces = {sp["trace"] for sp in hits}
    for tr in sorted(traces):
        spans = w.head_call("ListSpans", {"trace": tr, "limit": 10000},
                            timeout=10)
        print(f"trace {tr:x} ({len(spans)} spans)")
        print(format_trace_tree(spans))
    return 0


def _fmt_bytes(n) -> str:
    n = float(n or 0)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return f"{n:.1f} TiB"


def cmd_memory(args) -> int:
    """Cluster memory debugger (reference: ``ray memory``):
    every owned byte in the object plane attributed to the callsite /
    task that created it, plus the leak watchdog's current suspects."""
    from ray_tpu_torch.util import state as state_api

    _connect()
    group_by = args.group_by
    out = state_api.object_summary(group_by=group_by,
                                   detail=group_by in ("callsite", "creator"),
                                   limit=args.limit)
    nodes = out.get("nodes") or {}
    total_used = sum((nd.get("store") or {}).get("used", 0)
                     for nd in nodes.values())
    total_objs = sum((nd.get("store") or {}).get("num_objects", 0)
                     for nd in nodes.values())
    attr = out.get("attribution") or {}
    print(f"Object store: {_fmt_bytes(total_used)} used across "
          f"{len(nodes)} node(s), {total_objs} sealed object(s); "
          f"{attr.get('ratio', 0):.0%} of copies attributed to a "
          f"creating callsite/task")
    for node_id, nd in sorted(nodes.items()):
        if nd.get("error"):
            print(f"  {node_id[:12]}: unreachable ({nd['error']})")
            continue
        tiers = nd.get("tiers") or {}
        lin = nd.get("lineage") or {}
        print(f"  {node_id[:12]}: "
              f"shm {_fmt_bytes(tiers.get('shm_bytes', 0))} "
              f"({tiers.get('shm_objects', 0)}) / "
              f"disk {_fmt_bytes(tiers.get('disk_bytes', 0))} "
              f"({tiers.get('disk_objects', 0)}) / "
              f"remote {tiers.get('remote_objects', 0)}   "
              f"processes {nd.get('num_processes', 0)}   "
              f"lineage {lin.get('records', 0)} rec "
              f"({_fmt_bytes(lin.get('bytes', 0))}), "
              f"{lin.get('reconstructions', 0)} replayed, "
              f"{lin.get('evictions', 0)} evicted")

    groups = out.get("groups") or {}
    sort_key = {"bytes": "total_bytes", "count": "count"}[args.sort_by]
    ordered = sorted(groups.items(),
                     key=lambda kv: kv[1].get(sort_key, 0), reverse=True)
    print(f"\nGrouped by {group_by} (top {args.limit}, by {args.sort_by})")
    print("-" * 72)
    if group_by in ("callsite", "creator"):
        # LINEAGE = how many of the group's objects the owner can rebuild
        # by chained task replay if a copy is lost
        print(f"{'BYTES':>12} {'COUNT':>6} {'LOCAL':>6} {'BORROW':>6} "
              f"{'PINS':>5} {'LINEAGE':>7} {group_by.upper()}")
        for name, g in ordered[:args.limit]:
            print(f"{_fmt_bytes(g['total_bytes']):>12} {g['count']:>6} "
                  f"{g.get('local_refs', 0):>6} {g.get('borrowers', 0):>6} "
                  f"{g.get('task_pins', 0):>5} {g.get('lineage', 0):>7} "
                  f"{name}")
    else:
        print(f"{'BYTES':>12} {'COUNT':>6} {group_by.upper()}")
        for name, g in ordered[:args.limit]:
            print(f"{_fmt_bytes(g['total_bytes']):>12} {g['count']:>6} "
                  f"{name}")
    if not ordered:
        print("  (no objects)")

    if args.leaks:
        print("\nLeak suspects")
        print("-" * 72)
        any_suspect = False
        scans = 0
        for node_id, nd in sorted(nodes.items()):
            scans = max(scans, nd.get("leak_scans", 0))
            for s in nd.get("leak_suspects") or []:
                any_suspect = True
                print(f"  {node_id[:12]} {s['object_id'][:16]} "
                      f"{_fmt_bytes(s.get('size_bytes', 0)):>12} "
                      f"{s.get('reason'):<18} age {s.get('age_s', 0)}s  "
                      f"{s.get('callsite') or s.get('creator') or ''}")
        if not any_suspect:
            armed = scans > 0
            print("  none" + ("" if armed else
                              " (watchdog disarmed — set "
                              "RAY_TPU_TORCH_OBJECT_LEAK_SCAN_INTERVAL_S > 0 "
                              "on node start to arm it)"))
    return 0


def cmd_train_resume(args) -> int:
    """Elastic-training recovery report: every
    ``train_resume::`` span the flight recorder holds, grouped per
    restart incarnation — how long teardown, group re-form, restore
    dispatch, and time-to-first-result each took."""
    if getattr(args, "session", ""):
        # post-mortem: parse ring files off the session dir (the driver
        # that recorded the resume may itself be gone)
        from ray_tpu_torch._private.events import recover_session

        rings = recover_session(args.session)
        from ray_tpu_torch._private.events import _span_dict

        spans = []
        for ring in rings:
            for sp in ring["spans"]:
                spans.append(sp if isinstance(sp, dict) else _span_dict(sp))
    else:
        _connect()
        from ray_tpu_torch._private import worker as worker_mod

        w = worker_mod.global_worker
        w.flush_task_events(wait=True)
        spans = w.head_call("ListSpans", {"limit": 20000}, timeout=10) or []

    resumes = [sp for sp in spans
               if str(sp.get("name", "")).startswith("train_resume::")]
    if not resumes:
        print("no train_resume:: spans recorded (no elastic restart "
              "happened, or task_event_sample_rate is 0)")
        return 1

    # driver-side spans carry the restart ordinal; teardown is recorded
    # against the failing incarnation, the rest against the new one —
    # the ordinal, not the trace id, is the incarnation key. Worker-side
    # restore spans live in the workers' own traces; shown separately.
    by_restart: dict = {}
    worker_restores = []
    for sp in resumes:
        ex = sp.get("extra") or {}
        if sp["name"] == "train_resume::restore":
            worker_restores.append(sp)
        else:
            by_restart.setdefault(ex.get("restart"), []).append(sp)

    print(f"{len(by_restart)} recovery incarnation(s)")
    for restart in sorted(by_restart, key=lambda r: (r is None, r)):
        group = by_restart[restart]
        print(f"\nrestart #{restart if restart is not None else '?'}")
        for suffix, label in (
                ("teardown", "tear down failed group"),
                ("group_start", "re-form worker group"),
                ("start_training", "dispatch + in-store restore"),
                ("first_result", "first post-resume result"),
                ("total", "total time-to-resume")):
            for sp in group:
                if sp["name"] != f"train_resume::{suffix}":
                    continue
                ex = sp.get("extra") or {}
                notes = " ".join(f"{k}={v}" for k, v in sorted(ex.items())
                                 if k not in ("task", "restart"))
                print(f"  {label:<28} {sp.get('dur_us', 0) / 1e6:>8.3f}s"
                      f"  {notes}")
    if worker_restores:
        print("\nworker-side shard restores")
        for sp in sorted(worker_restores,
                         key=lambda s: ((s.get("extra") or {}).get("step", 0),
                                        (s.get("extra") or {}).get("rank", 0))):
            ex = sp.get("extra") or {}
            print(f"  rank {ex.get('rank', '?')} step {ex.get('step', '?')}"
                  f"  {sp.get('dur_us', 0) / 1e6:>8.3f}s"
                  f"  {ex.get('nbytes', 0)} B")
    return 0


def cmd_metrics(args) -> int:
    if getattr(args, "scrape", False) or getattr(args, "url", ""):
        # hit the head's HTTP scrape endpoint (metrics_export_port) the
        # way Prometheus would — proves the whole export path, not just
        # the in-process renderer
        import urllib.request

        url = args.url
        if not url:
            from ray_tpu_torch._private import lifecycle

            for sess in lifecycle.list_sessions():
                port_file = os.path.join(sess["path"], "metrics_port")
                if sess["live"] and os.path.exists(port_file):
                    with open(port_file) as f:
                        url = f"http://127.0.0.1:{f.read().strip()}/metrics"
                    break
            if not url:
                print("no live session exports metrics "
                      "(set RAY_TPU_TORCH_METRICS_EXPORT_PORT and restart the "
                      "head, or pass --url)")
                return 1
        with urllib.request.urlopen(url, timeout=10) as r:
            sys.stdout.write(r.read().decode())
        return 0
    from ray_tpu_torch.util.metrics import prometheus_text

    _connect()
    print(prometheus_text())
    return 0


def cmd_serve_deploy(args) -> int:
    """Declarative deploy from a JSON config file (reference: `serve
    deploy config.yaml`; JSON here — no yaml dep in the image)."""
    import json as _json

    from ray_tpu_torch import serve

    _connect()
    with open(args.config_file) as f:
        config = _json.load(f)
    serve.run_config(config)
    print(f"deployed {len(config.get('applications', []))} application(s)")
    return 0


def cmd_serve_status(args) -> int:
    import json as _json

    from ray_tpu_torch import serve

    _connect()
    try:
        ctrl = serve._controller()
        routes = __import__("ray_tpu_torch").get(
            ctrl.get_routes.remote(), timeout=30)
    except Exception:
        print(_json.dumps({"applications": {}}, indent=2))
        return 0
    out = {app: {**serve.status(app), "route_prefix": prefix}
           for prefix, (app, _ingress) in routes.items()}
    print(_json.dumps({"applications": out}, indent=2))
    return 0


def cmd_serve_shutdown(args) -> int:
    from ray_tpu_torch import serve

    _connect()
    serve.shutdown()
    print("serve shut down")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="ray-tpu", description="ray_tpu_torch cluster CLI")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("start", help="start a head or worker node")
    s.add_argument("--head", action="store_true")
    s.add_argument("--address", default="")
    s.add_argument("--port", type=int, default=0)
    s.add_argument("--num-cpus", dest="num_cpus", default=None)
    s.add_argument("--resources", default="")
    s.set_defaults(fn=cmd_start)

    s = sub.add_parser("stop", help="stop all locally-started nodes")
    s.add_argument("--all", action="store_true",
                   help="also reap every registered session daemon and "
                        "remove session dirs/shm segments")
    s.set_defaults(fn=cmd_stop)

    s = sub.add_parser(
        "up", help="launch a cluster from a YAML/JSON config (ray up)")
    s.add_argument("config")
    s.set_defaults(fn=cmd_up)

    s = sub.add_parser("down", help="tear down a launched cluster")
    s.add_argument("config")
    s.set_defaults(fn=cmd_down)

    s = sub.add_parser("status", help="cluster resources + nodes")
    s.set_defaults(fn=cmd_status)

    s = sub.add_parser("list", help="list cluster state")
    s.add_argument("resource", choices=[
        "actors", "nodes", "tasks", "placement-groups", "jobs",
        "workers", "objects"])
    s.set_defaults(fn=cmd_list)

    s = sub.add_parser("summary", help="summarize tasks/actors")
    s.add_argument("resource", choices=["tasks", "actors", "objects"])
    s.set_defaults(fn=cmd_summary)

    s = sub.add_parser(
        "timeline",
        help="dump Perfetto/chrome-trace timeline (flight-recorder spans)")
    s.add_argument("--output", default="")
    s.add_argument("--session", default="",
                   help="offline mode: read ring files from this session "
                        "dir instead of a live head (post-mortem)")
    s.set_defaults(fn=cmd_timeline)

    s = sub.add_parser(
        "trace", help="print one task's cross-process span tree")
    s.add_argument("task_id", help="task id hex (prefix ok)")
    s.set_defaults(fn=cmd_trace)

    s = sub.add_parser(
        "memory",
        help="cluster memory debugger: store bytes attributed to the "
             "callsite/task that created them, plus leak suspects")
    s.add_argument("--group-by", dest="group_by", default="callsite",
                   choices=["node", "callsite", "creator", "tier"],
                   help="attribution axis: creating callsite "
                        "(module:qualname:line of the put()/.remote()), "
                        "creating task/actor, residency tier, or node")
    s.add_argument("--sort-by", dest="sort_by", default="bytes",
                   choices=["bytes", "count"],
                   help="order groups by total bytes (default) or count")
    s.add_argument("--leaks", action="store_true",
                   help="show the leak watchdog's current suspects "
                        "(requires object_leak_scan_interval_s > 0 on "
                        "the node agents)")
    s.add_argument("--limit", type=int, default=20,
                   help="rows per section (default 20)")
    s.set_defaults(fn=cmd_memory)

    s = sub.add_parser(
        "train-resume",
        help="elastic-training recovery report: per-restart "
             "teardown / re-form / restore / first-result timings "
             "from the train_resume:: flight-recorder spans")
    s.add_argument("--session", default="",
                   help="offline mode: read ring files from this session "
                        "dir instead of a live head (post-mortem)")
    s.set_defaults(fn=cmd_train_resume)

    s = sub.add_parser("metrics", help="Prometheus metrics dump")
    s.add_argument("--scrape", action="store_true",
                   help="GET the head's HTTP scrape endpoint instead of "
                        "rendering in-process")
    s.add_argument("--url", default="",
                   help="explicit scrape URL (implies --scrape)")
    s.set_defaults(fn=cmd_metrics)

    serve_p = sub.add_parser("serve", help="serve control")
    serve_sub = serve_p.add_subparsers(dest="serve_cmd", required=True)
    s = serve_sub.add_parser("deploy", help="deploy a JSON config")
    s.add_argument("config_file")
    s.set_defaults(fn=cmd_serve_deploy)
    s = serve_sub.add_parser("status", help="application status")
    s.set_defaults(fn=cmd_serve_status)
    s = serve_sub.add_parser("shutdown", help="tear serve down")
    s.set_defaults(fn=cmd_serve_shutdown)

    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except BrokenPipeError:
        return 0


if __name__ == "__main__":
    sys.exit(main())
