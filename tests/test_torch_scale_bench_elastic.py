"""One of the port's envelope sections that boot their own clusters, at its
``--quick`` size on the CPU: ``train_elastic`` (two CPU workers under
``TorchTrainer``, one SIGKILLed mid-run) resumes from its in-store
checkpoint and ends on the ``w`` of an uninterrupted numpy run. The section
leaves no session of the port behind."""

import os
import pickle

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import numpy as np  # noqa: E402

import ray_tpu_torch.train  # noqa: E402
from ray_tpu_torch import scale_bench as bench  # noqa: E402
from tests.test_torch_runtime import (  # noqa: E402,F401
    no_port_session_left, other_workers_jax_sessions_end)


def _numpy_w(steps):
    """``bench_train_elastic``'s loop, uninterrupted."""
    rng = np.random.RandomState(0)
    X = rng.randn(64, 8)
    y = X @ rng.randn(8)
    w = np.zeros(8)
    for _ in range(steps):
        w = w - 0.05 * (2.0 * X.T @ (X @ w - y) / len(y))
    return w


def test_train_elastic_quick_resumes_onto_the_uninterrupted_w(
        monkeypatch, no_port_session_left):
    finals = []

    class Recording(ray_tpu_torch.train.TorchTrainer):
        def fit(self):
            res = super().fit()
            # read while the section's session is up
            finals.append((res.metrics,
                           pickle.loads(bytes(res.checkpoint.get_file(
                               "state.pkl")))))
            return res

    monkeypatch.setattr(ray_tpu_torch.train, "TorchTrainer", Recording)
    out = bench.bench_train_elastic(quick=True)
    assert out["steps"] == 80 and out["world_size"] == 2
    assert len(out["kills"]) == 1 and out["restarts"] >= 1
    assert out["restarts_counter"] >= 1
    assert 0 < out["resumed_from_step"] < 80
    assert out["time_to_resume_s"] is not None
    want = _numpy_w(80)
    (clean_m, clean), (chaos_m, chaos) = finals
    assert clean_m["resumed_from"] == 0
    assert chaos_m["resumed_from"] == out["resumed_from_step"]
    for state in (clean, chaos):
        assert state["step"] == 79
        np.testing.assert_array_equal(state["w"], want)
