"""One of the port's envelope sections that boot their own clusters, at its
``--quick`` size on the CPU: ``data_shuffle`` (a clean streaming and a
materializing shuffle, then one whose shard node is killed mid-iteration)
gives rows whose digest is the one numpy computes from the seed-2026 input
blocks, in all three runs, and replays its maps in workers that never
import torch. The section leaves no session of the port behind. Under
load its ledger gate caught a pulled copy that outlived its free
(``test_torch_late_location_notice.py`` holds that race).
``train_elastic`` is in ``test_torch_scale_bench_elastic.py``."""

import hashlib
import os

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import numpy as np  # noqa: E402

from ray_tpu_torch import scale_bench as bench  # noqa: E402
from tests.test_torch_runtime import (  # noqa: E402,F401
    no_port_session_left, other_workers_jax_sessions_end)


def _numpy_rows_digest():
    """``bench_data_shuffle``'s input at its quick width, in numpy: 8 blocks
    of 512 rows of 512 float32 from ``default_rng(2026)``, each row's
    (id, sha256 of x), sorted."""
    rng = np.random.default_rng(2026)
    rows = []
    for i in range(8):
        x = rng.random((512, 512)).astype(np.float32)
        rows += [(i * 512 + j, hashlib.sha256(x[j].tobytes()).hexdigest())
                 for j in range(512)]
    return hashlib.sha256(str(sorted(rows)).encode()).hexdigest()


def _store_contents():
    """The head store's objects and the deletes a reader's view refused."""
    from ray_tpu_torch._private import worker as wm

    w = wm.global_worker
    stats = w._acall(w.agent.call("GetStoreStats", {}, timeout=15),
                     timeout=20)
    objs = w._acall(w.agent.call("ListStoreObjects", {"limit": 50},
                                 timeout=15), timeout=20)
    out = {"used": stats.get("used"),
           "deferred_deletes": stats.get("deferred_deletes"),
           "objects": objs,
           "reconstructions": w._lineage.reconstructions,
           "pull_stats": w._acall(w.agent.call("GetPullStats", {},
                                               timeout=15), timeout=20)}
    import glob
    for o in objs:
        prefix = o["object_id"][:16]
        for path in glob.glob(os.path.join(w.session_dir, "logs", "*")):
            if not os.path.isfile(path):
                continue
            with open(path, errors="replace") as f:
                hits = [ln.strip()[:300] for ln in f if prefix in ln]
            if hits:
                out.setdefault("log_lines", {})[os.path.basename(path)] = \
                    hits[:20]
    return out


def test_data_shuffle_quick_is_byte_identical_and_torch_free(
        monkeypatch, no_port_session_left):
    from ray_tpu_torch.data.context import DataContext

    # the section sets these on the process's context: give them back
    ctx = DataContext.get_current()
    for field in ("streaming_shuffle", "shuffle_map_remote_args",
                  "shuffle_reduce_remote_args"):
        monkeypatch.setattr(ctx, field, getattr(ctx, field))
    digests = []
    digest = bench._rows_digest

    def recording(rows):
        digests.append(digest(rows))
        return digests[-1]

    drain = bench._ledger_drain

    def reporting_drain(base, timeout=30.0):
        out = drain(base, timeout)
        if not out["drained"]:
            # shown with the section's own assertion
            print("head store after the drain:", _store_contents())
        return out

    monkeypatch.setattr(bench, "_rows_digest", recording)
    monkeypatch.setattr(bench, "_ledger_drain", reporting_drain)
    out = bench.bench_data_shuffle(quick=True)
    assert "error" not in out["chaos"], out["chaos"]
    # streaming, materialize, then the run whose shard node was killed
    assert digests == [_numpy_rows_digest()] * 3
    assert out["byte_identical"] is True
    chaos = out["chaos"]
    assert chaos["byte_identical"] is True and chaos["rows"] == 4096
    assert chaos["torch_unimported_in_replay_workers"] is True
    assert chaos["lineage_reconstructions"] > 0
    for rec in (out["streaming"], out["materialize"], chaos):
        assert rec["post_run_ledger"]["drained"], rec
    assert out["streaming"]["zero_copy_puts"] > 0
