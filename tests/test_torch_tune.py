"""The port's Tune, its pure parts, against the JAX package's, with no
runtime.

``ray_tpu_torch.tune`` is a copy of ``ray_tpu.tune``: the reference's unit
cases run on the port (``tests/test_tune.py``'s three, the five stoppers, the
PB2 and gated cases of ``tests/test_tune_extras.py``, the five of
``tests/test_tune_bayesopt.py`` and the two TPE cases of
``tests/test_tune_bohb.py``), and identical inputs go through both packages:
the variants ``generate_variants`` draws from one seed, the suggestions TPE
and BayesOpt make after the same observed results, and the decisions ASHA,
HyperBand, MedianStopping, seeded PBT and PB2 take on one synthetic result
stream of fake trials (no runtime: a fake controller stands in for the
trial actors). Decisions and discrete values must be equal; continuous
values agree to 1e-12 relative."""

import math
import os
import random

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from ray_tpu import tune as jt  # noqa: E402
from ray_tpu.tune import experiment as jexp  # noqa: E402
from ray_tpu.tune.search import basic_variant as jbv  # noqa: E402
from ray_tpu_torch import tune  # noqa: E402
from ray_tpu_torch.tune import experiment as texp  # noqa: E402
from ray_tpu_torch.tune.schedulers import pb2 as tpb2  # noqa: E402
from ray_tpu_torch.tune.search import basic_variant as tbv  # noqa: E402
from ray_tpu_torch.tune.search import bayesopt as tbo  # noqa: E402
from ray_tpu_torch.tune.search.searcher import (  # noqa: E402
    ConcurrencyLimiter, Searcher)
from tests.test_torch_runtime import (  # noqa: E402,F401
    other_workers_jax_sessions_end)

TOL_CONTINUOUS = 1e-12


def _same(got, want, where="value"):
    """Equal, floats to TOL_CONTINUOUS relative; dicts, lists and tuples
    element by element."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), where
        for k in want:
            _same(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, float), (where, got, want)
        assert abs(got - want) <= TOL_CONTINUOUS * max(abs(want), 1e-300), \
            (where, got, want)
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


# ----------------------------------------------- tests/test_tune.py's units

def test_variant_generation_grid_and_domains():
    space = {
        "lr": tune.grid_search([0.1, 0.01]),
        "wd": tune.loguniform(1e-5, 1e-2),
        "layers": tune.choice([2, 4]),
        "nested": {"units": tune.grid_search([8, 16])},
    }
    variants = tbv.generate_variants(space, num_samples=2,
                                     rng=random.Random(0))
    assert len(variants) == 8  # 2 grid x 2 grid x 2 samples
    for v in variants:
        assert v["lr"] in (0.1, 0.01)
        assert 1e-5 <= v["wd"] <= 1e-2
        assert v["layers"] in (2, 4)
        assert v["nested"]["units"] in (8, 16)


def test_sample_domains_deterministic():
    rng = random.Random(42)
    assert 1 <= tune.randint(1, 10).sample(rng) < 10
    v = tune.quniform(0, 1, 0.25).sample(rng)
    assert v in (0.0, 0.25, 0.5, 0.75, 1.0)
    assert tune.choice(["a"]).sample(rng) == "a"


def test_concurrency_limiter():
    class Seq(Searcher):
        def __init__(self):
            super().__init__()
            self.n = 0

        def suggest(self, trial_id):
            self.n += 1
            return {"i": self.n}

    lim = ConcurrencyLimiter(Seq(), max_concurrent=2)
    assert lim.suggest("a") == {"i": 1}
    assert lim.suggest("b") == {"i": 2}
    assert lim.suggest("c") is None
    lim.on_trial_complete("a")
    assert lim.suggest("c") == {"i": 3}


# ---------------------------------------- tests/test_tune_extras.py's units

def _max_iteration():
    s = tune.MaximumIterationStopper(3)
    assert not s("t", {"training_iteration": 2})
    assert s("t", {"training_iteration": 3})


def _trial_plateau():
    s = tune.TrialPlateauStopper("loss", std=0.01, num_results=3,
                                 grace_period=3)
    assert not s("t", {"loss": 1.0})
    assert not s("t", {"loss": 0.5})
    assert not s("t", {"loss": 0.5})  # grace period just met; std high
    assert s("t", {"loss": 0.5})     # window now flat
    assert not s("u", {"loss": 0.5})  # another trial: its own history


def _combined_and_function():
    s = tune.CombinedStopper(
        tune.FunctionStopper(lambda tid, r: r.get("x", 0) > 10),
        tune.MaximumIterationStopper(100))
    assert s("t", {"x": 11})
    assert not s("t", {"x": 1})
    assert not s.stop_all()


def _timeout_stops_all():
    assert tune.TimeoutStopper(-1.0).stop_all()  # already expired


def _experiment_plateau():
    s = tune.ExperimentPlateauStopper("score", mode="max", top=2,
                                      patience=1)
    s("t", {"score": 1.0})
    assert not s.stop_all()  # top-k not yet full
    s("t", {"score": 1.0})
    s("t", {"score": 1.0})
    assert s.stop_all()
    s2 = tune.ExperimentPlateauStopper("score", mode="max", top=2,
                                       patience=1)
    for v in (1.0, 2.0, 3.0, 4.0):  # an improving metric resets staleness
        s2("t", {"score": v})
    assert not s2.stop_all()


@pytest.mark.parametrize("case", [
    _max_iteration, _trial_plateau, _combined_and_function,
    _timeout_stops_all, _experiment_plateau], ids=lambda f: f.__name__[1:])
def test_stopper(case):
    case()


def test_pb2_gp_suggestion_unit():
    """The GP explore step gives in-bounds configs and prefers the region
    where the observed improvement was higher."""
    sched = tpb2.PB2(metric="score", mode="max",
                     hyperparam_bounds={"lr": (0.0, 1.0)}, seed=0)
    rng = np.random.default_rng(0)
    for _ in range(40):  # improvement grows with lr
        lr = float(rng.random())
        sched._X.append([lr])
        sched._y.append(lr + 0.01 * rng.standard_normal())
    cfg = sched._explore({"lr": 0.2})
    assert 0.0 <= cfg["lr"] <= 1.0
    assert cfg["lr"] > 0.6, cfg  # UCB chases the upper region


def test_pb2_requires_bounds():
    with pytest.raises(ValueError):
        tpb2.PB2(metric="score", mode="max")


@pytest.mark.parametrize("name,lib", [
    ("OptunaSearch", "optuna"), ("HyperOptSearch", "hyperopt")])
def test_gated_searchers_raise_cleanly(name, lib):
    with pytest.raises(ImportError, match=lib):
        getattr(tune.search, name)({"lr": tune.uniform(0, 1)})


@pytest.mark.parametrize("module,name,lib", [
    ("skopt", "SkOptSearch", "skopt"),
    ("nevergrad", "NevergradSearch", "nevergrad"),
    ("ax", "AxSearch", "ax")])
def test_other_gated_searchers_raise_cleanly(module, name, lib):
    """The searchers ``tune.search`` does not export raise as the
    reference's do when their library is missing (none is installed)."""
    import importlib

    for pkg in ("ray_tpu", "ray_tpu_torch"):
        cls = getattr(importlib.import_module(f"{pkg}.tune.search.{module}"),
                      name)
        with pytest.raises(ImportError, match=lib):
            cls({"lr": tune.uniform(0, 1)})


@pytest.mark.parametrize("name,lib", [
    ("WandbLoggerCallback", "wandb"), ("MLflowLoggerCallback", "mlflow"),
    ("CometLoggerCallback", "comet_ml")])
def test_gated_tracking_integrations(name, lib):
    """``air.integrations``' callbacks, gated as in
    ``tests/test_util_extras.py``."""
    from ray_tpu_torch.air import integrations

    cls = getattr(integrations, name)
    try:
        __import__(lib)
    except ImportError:
        with pytest.raises(ImportError, match=lib):
            cls()
    else:
        cls()


def test_tbx_logger_gated():
    try:
        import tensorboardX  # noqa: F401
        has = True
    except ImportError:
        try:
            from torch.utils.tensorboard import SummaryWriter  # noqa: F401
            has = True
        except ImportError:
            has = False
    if has:
        tune.TBXLoggerCallback()
    else:
        with pytest.raises(ImportError):
            tune.TBXLoggerCallback()


# ------------------------------------- tests/test_tune_bayesopt.py's units

def _surface(x, y):
    return -((x - 0.7) ** 2) - ((y + 0.3) ** 2)


def _random_distance():
    rng = random.Random(3)
    d = [math.hypot(rng.uniform(-2, 2) - 0.7, rng.uniform(-2, 2) + 0.3)
         for _ in range(1000)]
    return sum(d) / len(d)


def test_gp_posterior_interpolates():
    X = np.array([[0.1], [0.5], [0.9]])
    y = np.array([1.0, 3.0, 2.0])
    gp = tbo._GP(X, y, length_scale=0.3, noise=1e-6)
    mu, sigma = gp.posterior(X)
    np.testing.assert_allclose(mu, y, atol=0.05)
    assert (sigma < 0.1).all()
    mu_far, sigma_far = gp.posterior(np.array([[5.0]]))
    assert abs(mu_far[0] - y.mean()) < 0.5
    assert sigma_far[0] > sigma.max()


def test_ei_prefers_high_mean_and_high_uncertainty():
    ei = tbo._expected_improvement(np.array([1.0, 2.0, 1.0]),
                                   np.array([0.1, 0.1, 2.0]), best=1.5)
    assert ei[1] > ei[0] and ei[2] > ei[0]


def test_bayesopt_concentrates_near_optimum():
    space = {"x": tune.uniform(-2.0, 2.0), "y": tune.uniform(-2.0, 2.0)}
    searcher = tbo.BayesOptSearcher(space=space, metric="score", mode="max",
                                    n_initial_points=10, seed=11)
    for i in range(45):
        cfg = searcher.suggest(f"t{i}")
        searcher.on_trial_complete(
            f"t{i}", {"score": _surface(cfg["x"], cfg["y"])})
    tail = []
    for i in range(8):
        cfg = searcher.suggest(f"probe{i}")
        tail.append(math.hypot(cfg["x"] - 0.7, cfg["y"] + 0.3))
        searcher.on_trial_complete(
            f"probe{i}", {"score": _surface(cfg["x"], cfg["y"])})
    assert sum(tail) / len(tail) < _random_distance() * 0.5, tail


def test_bayesopt_minimize_mode_and_mixed_dims():
    space = {"lr": tune.loguniform(1e-5, 1e-1),
             "layers": tune.randint(1, 8),
             "act": tune.choice(["relu", "gelu"])}
    searcher = tbo.BayesOptSearcher(space=space, metric="loss", mode="min",
                                    n_initial_points=6, seed=0)
    for i in range(30):
        cfg = searcher.suggest(f"t{i}")
        assert cfg["act"] in ("relu", "gelu")
        assert 1 <= cfg["layers"] < 8
        loss = (math.log10(cfg["lr"]) + 3.0) ** 2 - 0.05 * cfg["layers"]
        searcher.on_trial_complete(f"t{i}", {"loss": loss})
    probes = []
    for i in range(6):
        cfg = searcher.suggest(f"p{i}")
        probes.append(abs(math.log10(cfg["lr"]) + 3.0))
        searcher.on_trial_complete(
            f"p{i}", {"loss": (math.log10(cfg["lr"]) + 3.0) ** 2})
    assert sum(probes) / len(probes) < 1.0, probes


def test_bayesopt_state_roundtrip():
    space = {"x": tune.uniform(0.0, 1.0)}
    searcher = tbo.BayesOptSearcher(space=space, metric="score", mode="max",
                                    seed=1)
    for i in range(12):
        cfg = searcher.suggest(f"t{i}")
        searcher.on_trial_complete(f"t{i}", {"score": -abs(cfg["x"] - 0.4)})
    fresh = tbo.BayesOptSearcher(space=space, metric="score", mode="max")
    fresh.restore_state(searcher.save_state())
    assert len(fresh._obs) == len(searcher._obs)
    assert fresh.suggest("next") is not None


# ----------------------------------------- tests/test_tune_bohb.py's units

SPACE_XY = {"x": tune.uniform(-2.0, 2.0), "y": tune.uniform(-2.0, 2.0)}


def test_tpe_exploits_on_pure_model_level():
    searcher = tune.search.TPESearcher(space=dict(SPACE_XY), metric="score",
                                       mode="max", n_initial_points=12,
                                       seed=7)
    for i in range(60):
        cfg = searcher.suggest(f"t{i}")
        searcher.on_trial_complete(
            f"t{i}", {"score": 10.0 - 12.0 * ((cfg["x"] - 0.7) ** 2
                                              + (cfg["y"] + 0.3) ** 2)})
    searcher.epsilon = 0.0  # probe the model greedily
    tail = [math.hypot(c["x"] - 0.7, c["y"] + 0.3) for c in
            (searcher.suggest(f"probe{i}") for i in range(10))]
    assert sum(tail) / len(tail) < _random_distance() * 0.6, tail


def test_tpe_handles_categorical_and_log():
    space = {"lr": tune.loguniform(1e-5, 1e-1),
             "act": tune.choice(["relu", "gelu", "tanh"])}
    searcher = tune.search.TPESearcher(space=space, metric="score",
                                       mode="max", n_initial_points=10,
                                       seed=11)
    for i in range(80):
        cfg = searcher.suggest(f"t{i}")
        score = (5.0 if cfg["act"] == "gelu" else 0.0) - \
            abs(math.log10(cfg["lr"]) + 3.0)  # best: gelu, lr=1e-3
        searcher.on_trial_complete(f"t{i}", {"score": score})
    searcher.epsilon = 0.0
    hits = sum(1 for i in range(10)
               for cfg in [searcher.suggest(f"p{i}")]
               if cfg["act"] == "gelu" and 1e-4 < cfg["lr"] < 1e-2)
    assert hits >= 5, hits


# ------------------------------------------------- differential: variants

def _spaces(t):
    """Search spaces built from package ``t``'s constructors."""
    return {
        "grid_and_domains": {
            "lr": t.grid_search([0.1, 0.01, 0.001]),
            "wd": t.loguniform(1e-5, 1e-2),
            "drop": t.uniform(0.0, 0.5),
            "q": t.quniform(0, 1, 0.125),
            "layers": t.choice([2, 4, 8]),
            "width": t.randint(16, 512),
            "heads": t.lograndint(1, 64),
            "nested": {"units": t.grid_search([8, 16]),
                       "act": t.choice(["relu", "gelu"])},
        },
        "domains_only": {"x": t.uniform(-2, 2), "y": t.loguniform(1e-3, 10),
                         "k": t.randint(0, 3)},
        "grid_only": {"a": t.grid_search([1, 2]),
                      "b": t.grid_search(["u", "v", "w"])},
    }


@pytest.mark.parametrize("space", sorted(_spaces(tune)))
@pytest.mark.parametrize("seed", [0, 7])
def test_generate_variants_match_jax(space, seed):
    """The same space and seed give the same variants in the same order."""
    want = jbv.generate_variants(_spaces(jt)[space], 3, random.Random(seed))
    got = tbv.generate_variants(_spaces(tune)[space], 3, random.Random(seed))
    _same(got, want)


def test_basic_variant_generator_matches_jax():
    """The default searcher's suggestions, points to evaluate first, then
    the expanded space, then FINISHED."""
    runs = []
    for t, bv in ((jt, jbv), (tune, tbv)):
        gen = bv.BasicVariantGenerator(
            _spaces(t)["grid_and_domains"], num_samples=2, seed=5,
            points_to_evaluate=[{"lr": 0.5}])
        out = []
        while True:
            cfg = gen.suggest(f"t{len(out)}")
            if cfg == bv.Searcher.FINISHED:
                break
            out.append(cfg)
        runs.append(out)
    assert len(runs[0]) == 1 + 2 * 3 * 2
    _same(runs[1], runs[0])


# ---------------------------------------------- differential: searchers

def _objective(cfg):
    score = -((cfg["x"] - 0.7) ** 2) - (math.log10(cfg["lr"]) + 3.0) ** 2
    return score + (0.5 if cfg["act"] == "gelu" else 0.0) \
        - 0.01 * cfg["layers"]


def _searcher_space(t):
    return {"x": t.uniform(-2.0, 2.0), "lr": t.loguniform(1e-5, 1e-1),
            "act": t.choice(["relu", "gelu", "tanh"]),
            "layers": t.randint(1, 8)}


def _suggestions(make, t, n):
    searcher = make(t)
    out = []
    for i in range(n):
        cfg = searcher.suggest(f"t{i}")
        out.append(cfg)
        searcher.on_trial_result(f"t{i}", {"score": _objective(cfg),
                                           "training_iteration": 1})
        searcher.on_trial_complete(f"t{i}", {"score": _objective(cfg),
                                             "training_iteration": 1})
    return out


SEARCHERS = {
    "tpe": lambda t: t.search.TPESearcher(
        space=_searcher_space(t), metric="score", mode="max",
        n_initial_points=8, seed=3),
    "bohb": lambda t: t.search.TuneBOHB(
        space=_searcher_space(t), metric="score", mode="max",
        n_initial_points=8, seed=4),
    "bayesopt": lambda t: t.search.BayesOptSearcher(
        space=_searcher_space(t), metric="score", mode="min",
        n_initial_points=6, seed=5),
}


@pytest.mark.parametrize("name", sorted(SEARCHERS))
def test_searcher_suggestions_match_jax(name):
    """After the same observed results, the same suggestion sequence: the
    initial random points, then the model's."""
    n = 30 if name == "bayesopt" else 40
    want = _suggestions(SEARCHERS[name], jt, n)
    got = _suggestions(SEARCHERS[name], tune, n)
    _same(got, want)


# --------------------------------------------- differential: schedulers

class _FakeController:
    """What the schedulers call on the controller, with no trial actors: a
    trial's checkpoint is a name for its iteration, and a completion is
    recorded in the log."""

    def __init__(self, sched, log):
        self.trials, self.sched, self.log = [], sched, log
        self.iteration = {}

    def live_trials(self):
        return [t for t in self.trials if not t.is_finished]

    def trial_checkpoint(self, trial):
        trial.checkpoint_path = \
            f"{trial.trial_id}@{self.iteration[trial.trial_id]}"
        return trial.checkpoint_path

    def request_checkpoint(self, trial):
        self.log.append(("request_checkpoint", trial.trial_id))

    def _complete_trial(self, trial, result, early_stopped=False):
        self.log.append(("complete", trial.trial_id, early_stopped))
        self.sched.on_trial_complete(self, trial, result)
        trial.status = trial.TERMINATED


def _score(cfg, t, noise):
    """A learning curve: the rate ``q`` and ``lr`` set how fast it rises."""
    return float(cfg["q"] * math.log1p(t) * (1.0 + cfg["lr"]) + noise)


def _stream(t, exp, make, tmp_path, mode, n_trials=6, max_iter=12):
    """Fake trials report round by round; every decision, completion,
    checkpoint request and restart (with the new config and the restore
    path) goes into the log."""
    sched = make(t, mode)
    sched.set_search_properties("score", mode)
    log = []
    ctrl = _FakeController(sched, log)
    noise = np.random.default_rng(11).normal(0, 0.05, (n_trials, 64))
    for i in range(n_trials):
        trial = exp.Trial({"q": 0.5 + 0.25 * i, "lr": [0.1, 0.5, 0.9][i % 3]},
                          str(tmp_path), trial_id=f"t{i}")
        ctrl.trials.append(trial)
        ctrl.iteration[trial.trial_id] = 0
        sched.on_trial_add(ctrl, trial)
    sign = 1.0 if mode == "max" else -1.0
    may_resume = getattr(sched, "may_resume", None)
    for _ in range(4 * max_iter):
        for trial in list(ctrl.trials):
            tid = trial.trial_id
            if trial.is_finished:
                continue
            if trial.status == trial.PAUSED:
                if may_resume is not None and not may_resume(trial):
                    continue
                trial.status = trial.RUNNING
            ctrl.iteration[tid] += 1
            it = ctrl.iteration[tid]
            i = int(tid[1:])
            result = {"training_iteration": it, "trial_id": tid,
                      "score": sign * _score(trial.config, it,
                                             noise[i, it])}
            trial.last_result = result
            decision = sched.on_trial_result(ctrl, trial, result)
            log.append((tid, it, decision))
            if decision == "RESTART":
                log.append(("restart", tid, dict(trial.config),
                            trial.restore_path))
                ctrl.iteration[tid] = int(trial.restore_path.split("@")[1])
            elif decision == "PAUSE":
                trial.status = trial.PAUSED
            elif decision == "STOP" or it >= max_iter:
                ctrl._complete_trial(trial, result,
                                     early_stopped=decision == "STOP")
    return log


SCHEDULERS = {
    "asha": lambda t, mode: t.ASHAScheduler(
        max_t=12, grace_period=1, reduction_factor=2),
    "asha_brackets": lambda t, mode: t.ASHAScheduler(
        max_t=12, grace_period=1, reduction_factor=3, brackets=2),
    "hyperband": lambda t, mode: t.HyperBandScheduler(
        max_t=9, reduction_factor=3),
    "median": lambda t, mode: t.MedianStoppingRule(
        grace_period=2, min_samples_required=2),
    "pbt": lambda t, mode: t.PopulationBasedTraining(
        perturbation_interval=3, seed=0, quantile_fraction=0.5,
        hyperparam_mutations={"lr": [0.1, 0.3, 0.5, 0.7, 0.9],
                              "q": t.uniform(0.5, 2.0)}),
    "pb2": lambda t, mode: t.PB2(
        perturbation_interval=2, seed=0, quantile_fraction=0.5,
        hyperparam_bounds={"lr": (0.1, 0.9), "q": (0.5, 2.0)}),
}


@pytest.mark.parametrize("mode", ["max", "min"])
@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_decisions_match_jax(name, mode, tmp_path):
    """One synthetic result stream of 6 fake trials through the JAX
    package's scheduler and the port's: the same decisions at the same
    iterations, the same early stops, checkpoint requests and restarts
    (PBT's and PB2's mutated configs to 1e-12)."""
    want = _stream(jt, jexp, SCHEDULERS[name], tmp_path / "jax", mode)
    got = _stream(tune, texp, SCHEDULERS[name], tmp_path / "torch", mode)
    _same(got, want)
    decisions = {entry[2] for entry in want if len(entry) == 3
                 and isinstance(entry[2], str)}
    # each stream makes the scheduler act, not only continue
    acts = {"asha": "STOP", "asha_brackets": "STOP", "hyperband": "PAUSE",
            "median": "STOP", "pbt": "RESTART", "pb2": "RESTART"}[name]
    assert acts in decisions, decisions
