"""ray_tpu_torch's serving slice on the CPU: ``LlamaGenerator`` against the
JAX ``LlamaGenerator`` with the same weights and adapters, the engine copy's
error paths, the device rule, and the package's import boundary."""

import ast
import dataclasses
import os
import pathlib
import re
import subprocess
import sys
import threading

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from ray_tpu.models.llama import LlamaConfig as JaxLlamaConfig  # noqa: E402
from ray_tpu.serve.llm import LlamaGenerator as JaxLlamaGenerator  # noqa: E402
from ray_tpu_torch.exceptions import BackPressureError  # noqa: E402
from ray_tpu_torch.models.llama import (  # noqa: E402
    LlamaConfig, lora_from_jax, params_from_jax)
from ray_tpu_torch.serve._private.engine import (  # noqa: E402
    ContinuousBatchingEngine)
from ray_tpu_torch.serve.llm import LlamaGenerator  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent

# 4 concurrent requests, as tests/test_serve_load.py drives the JAX one
REQUESTS = [([3, 5, 7], ""), ([3, 5, 7], "a1"), ([11, 2, 9, 4, 1], "a2"),
            ([3, 5, 7], "a1")]
GEN_KW = dict(lora_rank=2, max_batch_size=2, allowed_batch_sizes=(1, 2),
              max_new_tokens=6, seq_bucket=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as tests/conftest.py sets for XLA: the tier runs
    files in parallel worker processes that must not starve each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _generate(gen, requests, max_new):
    out, errors, threads = {}, [], []
    for i, (prompt, adapter) in enumerate(requests):
        def run(idx=i, prompt=prompt, ad=adapter):
            try:
                out[idx] = list(gen({"prompt": prompt, "max_new": max_new,
                                     "adapter": ad}))
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        t = threading.Thread(target=run)
        t.start()
        threads.append(t)
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive(), "llama generation hung"
    if errors:
        raise errors[0]
    return [out[i] for i in range(len(requests))]


def test_generator_matches_jax_generator():
    jcfg = dataclasses.replace(JaxLlamaConfig.tiny(), dtype=jnp.float32)
    tcfg = dataclasses.replace(LlamaConfig.tiny(), dtype=torch.float32)
    jgen = JaxLlamaGenerator(config=jcfg, **GEN_KW)
    tgen = LlamaGenerator(config=tcfg, device="cpu", **GEN_KW)
    try:
        # same weights and adapters on both sides
        tgen._params = params_from_jax(jax.tree.map(np.asarray, jgen._params))
        for ad in ("a1", "a2"):
            tgen._adapters[ad] = lora_from_jax(
                jax.tree.map(np.asarray, jgen._adapter(ad)))
        want = _generate(jgen, REQUESTS, 6)
        got = _generate(tgen, REQUESTS, 6)
        assert got == want
        assert all(len(t) == 6 for t in got)
        assert got[1] == got[3], "same adapter diverged across batches"
        assert got[0] != got[1], "adapter had no effect"
        assert tgen.engine.stats()["completed"] == len(REQUESTS)
    finally:
        jgen.engine.shutdown()
        tgen.engine.shutdown()


def test_generator_own_weights_and_adapters():
    gen = LlamaGenerator(config="debug_1l", device="cpu", seed=7, **GEN_KW)
    try:
        got = _generate(gen, REQUESTS, 4)
        assert all(len(t) == 4 for t in got)
        assert all(0 <= x < gen._cfg.vocab_size for t in got for x in t)
        assert got[1] == got[3]
        # every leaf in the activation type: init_llama stores the norms in
        # param_dtype too, as the reference's does
        assert gen._params["layers"]["wq"].dtype == torch.bfloat16
        assert gen._params["final_norm"].dtype == torch.bfloat16
        a1 = gen._adapter("a1")["layers"]["wq"]
        assert a1["b"].abs().sum() > 0, "adapter B not nudged"
        # deterministic per id: a fresh generator draws the same adapter
        other = LlamaGenerator(config="debug_1l", device="cpu", seed=7,
                               **GEN_KW)
        torch.testing.assert_close(other._adapter("a1")["layers"]["wq"]["a"],
                                   a1["a"], rtol=0, atol=0)
        other.engine.shutdown()
    finally:
        gen.engine.shutdown()


def test_engine_step_failure_reaches_every_request():
    def step(model_id, states):
        raise RuntimeError("boom in step")

    eng = ContinuousBatchingEngine(step, max_batch_size=2)
    try:
        gens = [eng.submit({"x": i}) for i in range(2)]
        for g in gens:
            with pytest.raises(RuntimeError, match="boom in step"):
                list(g)
    finally:
        eng.shutdown()


def test_engine_sheds_past_max_pending():
    release = threading.Event()

    def step(model_id, states):
        release.wait(10)
        return [(1, True) if s is not None else None for s in states]

    eng = ContinuousBatchingEngine(step, max_batch_size=1, max_pending=1)
    try:
        first = eng.submit({})
        with pytest.raises(BackPressureError) as ei:
            eng.submit({})
        assert eng.stats()["shed"] == 1
        assert ei.value.queue_depths == {"engine": 1}
        release.set()
        assert list(first) == [1]
    finally:
        release.set()
        eng.shutdown()


def test_engine_records_a_step_span(tmp_path):
    """The engine's flight-recorder hook, on the port's copy of
    ``_private/events``: one sampled ``engine_step`` span per iteration
    with its batch, bucket and pad."""
    from ray_tpu_torch._private.events import REC

    def step(model_id, states):
        return [(1, True) if s is not None else None for s in states]

    assert REC.configure(str(tmp_path), "test", sample_rate=1.0)
    eng = ContinuousBatchingEngine(step, max_batch_size=2,
                                   allowed_batch_sizes=(2,))
    try:
        assert list(eng.submit({}, "m1")) == [1]
        spans = [s for s in REC.drain() if s[3].startswith("engine_step::")]
    finally:
        eng.shutdown()
        REC.configure(str(tmp_path), "test", sample_rate=0.0)
    assert [s[3] for s in spans] == ["engine_step::m1"]
    assert spans[0][4] == "serve"
    assert spans[0][7] == {"batch": 1, "bucket": 2, "pad": 1}


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LlamaGenerator(config="debug_1l")


def test_package_imports_no_jax_and_no_ray_tpu():
    """Every module of the package, the runtime's, Data's and Tune's copies,
    RLlib's rollout and algorithm layers and its on-policy, off-policy
    and offline families, the sharded checkpoints, the framework trainers,
    ``cluster_utils``, ``util``'s state, chaos, actor pool, queue and
    check_serialize, the DAG API and its channel, and the rest of ``util``
    (accelerators, tracing, multiprocessing, joblib, iter, dask, rpdb, the
    ``ray://`` client) included, imports neither jax
    nor ``ray_tpu``; no import statement names them, and no string is a jax
    or ``ray_tpu`` module path (``python -m ...``)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import ray_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    ray_tpu_torch.__path__, 'ray_tpu_torch.')]\n"
        "assert len(names) > 60, names\n"
        "assert {'ray_tpu_torch.data', 'ray_tpu_torch.data.iterator',\n"
        "        'ray_tpu_torch.data._internal.streaming_shuffle',\n"
        "        'ray_tpu_torch.tune', 'ray_tpu_torch.tune.tuner',\n"
        "        'ray_tpu_torch.tune.execution.tune_controller',\n"
        "        'ray_tpu_torch.air.integrations',\n"
        "        'ray_tpu_torch.rllib.env.env_runner',\n"
        "        'ray_tpu_torch.rllib.env.vector',\n"
        "        'ray_tpu_torch.rllib.env.multi_agent_env',\n"
        "        'ray_tpu_torch.rllib.env.policy_server_input',\n"
        "        'ray_tpu_torch.rllib.utils.vtrace',\n"
        "        'ray_tpu_torch.rllib.connectors.connector',\n"
        "        'ray_tpu_torch.rllib.offline.json_io',\n"
        "        'ray_tpu_torch.rllib.algorithms.algorithm',\n"
        "        'ray_tpu_torch.rllib.algorithms.ppo.multi_agent',\n"
        "        'ray_tpu_torch.rllib.algorithms.a2c.a2c',\n"
        "        'ray_tpu_torch.rllib.algorithms.ddppo.ddppo',\n"
        "        'ray_tpu_torch.rllib.algorithms.impala.impala',\n"
        "        'ray_tpu_torch.rllib.algorithms.appo.appo',\n"
        "        'ray_tpu_torch.rllib.algorithms.dqn.dqn',\n"
        "        'ray_tpu_torch.rllib.algorithms.apex.apex',\n"
        "        'ray_tpu_torch.rllib.algorithms.r2d2.r2d2',\n"
        "        'ray_tpu_torch.rllib.algorithms.sac.sac',\n"
        "        'ray_tpu_torch.rllib.algorithms.ddpg.ddpg',\n"
        "        'ray_tpu_torch.rllib.algorithms.cql.cql',\n"
        "        'ray_tpu_torch.rllib.algorithms.bc.bc',\n"
        "        'ray_tpu_torch.rllib.algorithms.marwil.marwil',\n"
        "        'ray_tpu_torch.rllib.algorithms.crr.crr',\n"
        "        'ray_tpu_torch.train._checkpoint',\n"
        "        'ray_tpu_torch.train.accelerate', 'ray_tpu_torch.train.gbdt',\n"
        "        'ray_tpu_torch.train.huggingface',\n"
        "        'ray_tpu_torch.train.huggingface.transformers_trainer',\n"
        "        'ray_tpu_torch.cluster_utils',\n"
        "        'ray_tpu_torch.util.actor_pool', 'ray_tpu_torch.util.queue',\n"
        "        'ray_tpu_torch.util.check_serialize',\n"
        "        'ray_tpu_torch.util.state', 'ray_tpu_torch.util.chaos',\n"
        "        'ray_tpu_torch.dag', 'ray_tpu_torch.experimental.channel',\n"
        "        'ray_tpu_torch.util.accelerators',\n"
        "        'ray_tpu_torch.util.accelerators.tpu',\n"
        "        'ray_tpu_torch.util.tracing',\n"
        "        'ray_tpu_torch.util.tracing.tracing_helper',\n"
        "        'ray_tpu_torch.util.multiprocessing',\n"
        "        'ray_tpu_torch.util.multiprocessing.pool',\n"
        "        'ray_tpu_torch.util.joblib',\n"
        "        'ray_tpu_torch.util.joblib.ray_backend',\n"
        "        'ray_tpu_torch.util.iter', 'ray_tpu_torch.util.dask',\n"
        "        'ray_tpu_torch.util.rpdb', 'ray_tpu_torch.util.client',\n"
        "        'ray_tpu_torch.util.client.client',\n"
        "        'ray_tpu_torch.util.client.server'} <= "
        "set(names), names\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ray_tpu')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr

    offenders = []
    for path in sorted((REPO / "ray_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            elif isinstance(node, ast.Constant) and isinstance(node.value,
                                                               str):
                # a whole string that is a module path, to run or import
                # (docstrings name the reference's modules freely)
                names = [node.value] if re.fullmatch(
                    r"(?:jax|jaxlib|ray_tpu)(?:\.\w+)+", node.value) else []
            else:
                continue
            offenders += [f"{path.name}: {n}" for n in names
                          if n.split(".")[0] in ("jax", "jaxlib", "ray_tpu")]
    assert not offenders, offenders
