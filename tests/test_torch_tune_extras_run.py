"""ray_tpu_torch's Tune on the port's runtime, on the CPU, continued: the
end-to-end cases of ``tests/test_tune_extras.py`` (a stopper with the
default loggers, callback hooks, HyperBand, PB2) and of
``tests/test_tune_bohb.py`` (BOHB against ASHA) to the same expectations.
The cluster, the deadlines and the rule that trainables are defined inside
the tests are ``tests/test_torch_tune_run.py``'s."""

import json
import os
import pkgutil
import types

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import pytest  # noqa: E402

from ray_tpu_torch import tune  # noqa: E402
from ray_tpu_torch.air.config import RunConfig  # noqa: E402
from ray_tpu_torch.tune import TuneConfig, Tuner  # noqa: E402
from ray_tpu_torch.tune.schedulers import (  # noqa: E402
    ASHAScheduler, HyperBandForBOHB)
from ray_tpu_torch.tune.search import TuneBOHB  # noqa: E402
from ray_tpu_torch.tune.search.basic_variant import (  # noqa: E402
    BasicVariantGenerator)
from ray_tpu_torch.tune.search.searcher import Searcher  # noqa: E402
from tests.test_torch_tune_run import port_cluster  # noqa: E402,F401
from tests.test_torch_runtime import (  # noqa: E402,F401
    other_workers_jax_sessions_end)


def _train_fn():
    def train_fn(config):
        from ray_tpu_torch import tune

        for i in range(20):
            tune.report({"score": (i + 1) * config["m"],
                         "loss": 1.0 / (i + 1)})

    return train_fn


def test_stopper_and_default_loggers_e2e(port_cluster, tmp_path):
    grid = Tuner(
        _train_fn(), param_space={"m": tune.grid_search([1, 2])},
        tune_config=TuneConfig(metric="score", mode="max"),
        run_config=RunConfig(storage_path=str(tmp_path), name="stop_e2e",
                             stop=tune.MaximumIterationStopper(5)),
    ).fit()
    assert len(grid) == 2
    assert all(r.metrics["training_iteration"] == 5 for r in grid)
    # the default loggers wrote result.json and progress.csv
    exp_dir = os.path.join(str(tmp_path), "stop_e2e")
    trial_dirs = [os.path.join(exp_dir, d) for d in os.listdir(exp_dir)
                  if os.path.isdir(os.path.join(exp_dir, d))]
    assert trial_dirs
    found_json = found_csv = False
    for p in trial_dirs:
        if os.path.exists(os.path.join(p, "result.json")):
            found_json = True
            with open(os.path.join(p, "result.json")) as f:
                lines = [json.loads(ln) for ln in f if ln.strip()]
            assert len(lines) == 5 and "score" in lines[0]
        found_csv |= os.path.exists(os.path.join(p, "progress.csv"))
    assert found_json and found_csv


def test_custom_callback_hooks(port_cluster, tmp_path):
    events = []

    class Recorder(tune.Callback):
        def on_trial_start(self, it, trials, trial):
            events.append(("start", trial.trial_id))

        def on_trial_result(self, it, trials, trial, result):
            events.append(("result", trial.trial_id))

        def on_trial_complete(self, it, trials, trial):
            events.append(("complete", trial.trial_id))

    Tuner(
        _train_fn(), param_space={"m": 1},
        tune_config=TuneConfig(metric="score", mode="max", num_samples=1),
        run_config=RunConfig(storage_path=str(tmp_path), name="cb",
                             stop={"training_iteration": 3},
                             callbacks=[Recorder()]),
    ).fit()
    kinds = [e[0] for e in events]
    assert "start" in kinds and "result" in kinds and "complete" in kinds


def test_hyperband_stops_bad_trials(port_cluster, tmp_path):
    def trainable(config):
        # HyperBand pauses and resumes trials at its rung barriers, so the
        # loop's progress must survive the restart
        import json
        import os
        import tempfile

        from ray_tpu_torch import tune
        from ray_tpu_torch.train import Checkpoint

        start = 0
        ckpt = tune.get_checkpoint()
        if ckpt:
            with open(os.path.join(ckpt.path, "state.json")) as f:
                start = json.load(f)["i"] + 1
        for i in range(start, 30):
            d = tempfile.mkdtemp()
            with open(os.path.join(d, "state.json"), "w") as f:
                json.dump({"i": i}, f)
            tune.report({"score": config["q"] * (i + 1)},
                        checkpoint=Checkpoint(d))

    grid = Tuner(
        trainable, param_space={"q": tune.grid_search([1, 2, 3, 4, 5, 6])},
        tune_config=TuneConfig(
            metric="score", mode="max",
            scheduler=tune.HyperBandScheduler(max_t=9, reduction_factor=3)),
        run_config=RunConfig(storage_path=str(tmp_path), name="hb",
                             stop={"training_iteration": 9}),
    ).fit()
    iters = sorted(r.metrics.get("training_iteration", 0) for r in grid)
    assert iters[0] < 9  # successive halving stopped one early
    best = max(grid, key=lambda r: r.metrics.get("score", -1))
    assert best.config["q"] == 6
    assert best.metrics["training_iteration"] == 9


def test_pb2_e2e_improves(port_cluster, tmp_path):
    def trainable(config):
        import json
        import os
        import tempfile

        from ray_tpu_torch import tune
        from ray_tpu_torch.train import Checkpoint

        score = 0.0
        ckpt = tune.get_checkpoint()
        if ckpt:
            with open(os.path.join(ckpt.path, "s.json")) as f:
                score = json.load(f)["score"]
        for _ in range(20):
            score += config["lr"]  # a higher lr is strictly better
            d = tempfile.mkdtemp()
            with open(os.path.join(d, "s.json"), "w") as f:
                json.dump({"score": score}, f)
            tune.report({"score": score}, checkpoint=Checkpoint(d))

    grid = Tuner(
        trainable, param_space={"lr": tune.uniform(0.1, 1.0)},
        tune_config=TuneConfig(
            metric="score", mode="max", num_samples=4,
            scheduler=tune.PB2(perturbation_interval=4, seed=0,
                               hyperparam_bounds={"lr": (0.1, 1.0)})),
        run_config=RunConfig(storage_path=str(tmp_path), name="pb2",
                             stop={"training_iteration": 12}),
    ).fit()
    assert all(0.1 <= r.config["lr"] <= 1.0 for r in grid)
    assert len(grid) == 4


class _InBatches(Searcher):
    """A searcher served in batches of ``size`` trials: the next batch is
    suggested only when every trial of the last one has completed, and the
    wrapped searcher sees the batch's results then, in the order the trials
    were suggested (each trial's in its own order). What it suggests no
    longer depends on the order in which concurrent trials report (Ray
    Tune's ``ConcurrencyLimiter(batch=True)``)."""

    def __init__(self, searcher, size):
        super().__init__(searcher.metric, searcher.mode)
        self.searcher, self.size = searcher, size
        self._batch, self._done, self._events = [], set(), {}

    def set_search_properties(self, metric, mode, config):
        super().set_search_properties(metric, mode, config)
        return self.searcher.set_search_properties(metric, mode, config)

    def suggest(self, trial_id):
        if len(self._batch) == self.size:
            if self._done != set(self._batch):
                return None
            for tid in self._batch:
                for hook, args in self._events.pop(tid, []):
                    getattr(self.searcher, hook)(tid, *args)
            self._batch, self._done = [], set()
        out = self.searcher.suggest(trial_id)
        if out is not None and out != Searcher.FINISHED:
            self._batch.append(trial_id)
        return out

    def on_trial_result(self, trial_id, result):
        self._events.setdefault(trial_id, []).append(
            ("on_trial_result", (result,)))

    def on_trial_complete(self, trial_id, result=None, error=False):
        self._events.setdefault(trial_id, []).append(
            ("on_trial_complete", (result, error)))
        self._done.add(trial_id)


def test_bohb_end_to_end_beats_or_matches_asha(port_cluster, tmp_path):
    """The same trial budget: BOHB's model-guided search finds a best score
    at least as good as ASHA with random search, within the reference's
    tolerance, and stops some trials early.

    Both sweeps are deterministic. BOHB's synchronous brackets need trials
    that run at once, so BOHB runs 4 at a time with its searcher served in
    batches of 4 (``_InBatches``): its brackets' cuts wait for every live
    member, and its model sees each batch's results in one order. ASHA,
    asynchronous, runs one trial at a time from a seeded random search.
    With 4 trials reporting at once and nothing ordering them, BOHB's model
    saw its observations in an order that varied with the load, and so did
    its best (6.6 against ASHA's 9.8 in one loaded run); and a trial
    paused at a rung started again from its first iteration, so the scores
    it reported after that depended on whether it had been the one to
    wait."""
    n_samples = 32

    def objective(config):
        import json
        import os
        import tempfile

        from ray_tpu_torch import tune
        from ray_tpu_torch.train import Checkpoint

        # a trial paused at a bracket's rung resumes from its checkpoint:
        # without one it would start again at i = 1, and which trials
        # pause depends on which member of a bracket reports last
        start = 1
        ckpt = tune.get_checkpoint()
        if ckpt:
            with open(os.path.join(ckpt.path, "i.json")) as f:
                start = json.load(f)["i"] + 1
        for i in range(start, 10):
            # low budgets see a noisy shifted surface that converges to
            # the true one (optimum 10 at (0.7, -0.3))
            frac = i / 9.0
            true = 10.0 - 12.0 * ((config["x"] - 0.7) ** 2
                                  + (config["y"] + 0.3) ** 2)
            d = tempfile.mkdtemp()
            with open(os.path.join(d, "i.json"), "w") as f:
                json.dump({"i": i}, f)
            tune.report({"score": frac * true
                         + (1 - frac) * (5.0 - abs(config["x"]))},
                        checkpoint=Checkpoint(d))

    def run(name, scheduler, searcher, concurrent):
        results = Tuner(
            objective,
            param_space={"x": tune.uniform(-2.0, 2.0),
                         "y": tune.uniform(-2.0, 2.0)},
            tune_config=TuneConfig(
                metric="score", mode="max", num_samples=n_samples,
                max_concurrent_trials=concurrent, scheduler=scheduler,
                search_alg=searcher),
            run_config=RunConfig(name=name, storage_path=str(tmp_path)),
        ).fit()
        return (results.get_best_result().metrics["score"],
                [r.metrics["training_iteration"] for r in results])

    bohb_best, bohb_iters = run(
        "bohb", HyperBandForBOHB(max_t=9, reduction_factor=3),
        _InBatches(TuneBOHB(metric="score", mode="max", n_initial_points=8,
                            seed=5), 4), 4)
    asha_best, _ = run(
        "asha", ASHAScheduler(max_t=9, grace_period=1, reduction_factor=3),
        BasicVariantGenerator(num_samples=n_samples, seed=0), 1)
    print(f"BOHB best {bohb_best}, ASHA best {asha_best}, BOHB iterations "
          f"{sum(bohb_iters)}")
    assert bohb_best >= asha_best - 3.0, (bohb_best, asha_best)
    assert bohb_best > 6.0, bohb_best
    assert min(bohb_iters) < 9, bohb_iters
    assert sum(bohb_iters) <= 0.85 * n_samples * 9, sum(bohb_iters)


@pytest.mark.parametrize("kind", ["searchers", "schedulers"])
def test_public_names_match_jax(kind):
    """``ray_tpu_torch.tune`` exports what ``ray_tpu.tune`` does."""
    from ray_tpu import tune as jt

    if kind == "searchers":
        # a package's live __dict__ gains a submodule's name once anything
        # imports that submodule, so the names are compared apart from the
        # modules, and the submodules are read from each package's files
        def public(ns):
            return {n for n, v in vars(ns).items() if not n.startswith("_")
                    and not isinstance(v, types.ModuleType)}

        def submodules(pkg):
            return {m.name for m in pkgutil.iter_modules(pkg.__path__)}

        assert public(tune.search) >= public(jt.search)
        assert submodules(tune.search) == submodules(jt.search)
    else:
        assert set(tune.__all__) == set(jt.__all__)
        assert set(tune.schedulers.__all__) == set(jt.schedulers.__all__)
