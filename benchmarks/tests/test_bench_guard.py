"""The import guard, and a run's refusals: no card, no program."""

import os
import shutil
import subprocess
import sys

from benchmarks import harness
from benchmarks.run import judge


def test_guard_compares_whole_top_level_names():
    mods = ["ray_tpu", "ray_tpu.serve", "jax", "jax.numpy", "jaxlib.xla",
            "flax.linen", "ray_tpu_torch", "ray_tpu_torch.serve",
            "jaxtyping", "flaxen", "ray_tpuX.y", "numpy"]
    assert harness.forbidden_modules(mods) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla", "ray_tpu",
        "ray_tpu.serve"]


def test_harness_and_program_load_no_jax():
    code = ("import sys; import benchmarks.run, benchmarks.control; "
            "import benchmarks.drivers.serve, benchmarks.drivers.train, "
            "benchmarks.drivers.train_loop, benchmarks.drivers.serve_generator;"
            " import benchmarks.reference.llama, benchmarks.reference.moe; "
            "from benchmarks.harness import forbidden_modules; "
            "print(forbidden_modules())")
    env = dict(os.environ, PYTHONPATH=str(harness.ROOT))
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "-m", "benchmarks.run", "--workload",
         "mistral-7b.serve-chat", "--seed", str(2 ** 33 + 5), "--seconds",
         "1", "--trace", "0"], cwd=harness.ROOT, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_run_refuses_without_the_program(tmp_path):
    shutil.copy(harness.MANIFEST, tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.HERE, tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "benchmarks.run", "--workload",
         "mistral-7b.serve-chat", "--seed", "7", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_judge_needs_every_limit():
    ok, checks = judge({"max_gap": 0.1}, {"max_gap": {"limit": 0.2}})
    assert ok and checks == {"max_gap": {"value": 0.1, "limit": 0.2}}
    assert not judge({"max_gap": 0.3}, {"max_gap": {"limit": 0.2}})[0]
    assert not judge({}, {"max_gap": {"limit": 0.2}})[0]
    assert not judge({"max_gap": 0.1}, {})[0]
