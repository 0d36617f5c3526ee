"""The port's framework trainers on its runtime, on the CPU: the four
cases of the JAX package's ``tests/test_train_trainers.py`` (a tiny
transformers fine-tune through ``TransformersTrainer`` and
``prepare_trainer``, a tiny ``accelerate`` loop through
``AccelerateTrainer``, and the ``lightning``, ``xgboost`` and ``lightgbm``
gates), with ``ScalingConfig(use_gpu=False)`` where the reference's
trainers take the CPU by default. The gates raise the reference's
``ImportError`` text, and ``ray_tpu_torch.train.__all__`` is the
reference's with ``JaxTrainer``, ``JaxConfig`` and ``JaxPredictor`` in
their port's names (``TorchTrainer``, ``TorchConfig``,
``ParamsPredictor``). The chip machine has neither transformers nor
accelerate: these trainers are held here only.

Train loops are defined inside the tests, so that they travel by value and
no worker imports this module (and with it jax)."""

import os

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import pytest  # noqa: E402

import ray_tpu_torch  # noqa: E402
from ray_tpu_torch.train import ScalingConfig  # noqa: E402
from tests.test_torch_runtime import port_session_leak_check  # noqa: E402
from tests.test_torch_runtime import (  # noqa: E402,F401
    other_workers_jax_sessions_end)

CPU1 = ScalingConfig(num_workers=1, use_gpu=False)


@pytest.fixture(scope="module")
def port4():
    key = "RAY_TPU_TORCH_TRAIN_RESULT_TIMEOUT_S"
    old = os.environ.get(key)
    os.environ[key] = "120"
    ray_tpu_torch.init(num_cpus=4)
    session_dir = ray_tpu_torch._global_node.session_dir
    yield session_dir
    ray_tpu_torch.shutdown()
    if old is None:
        os.environ.pop(key, None)
    else:
        os.environ[key] = old
    port_session_leak_check(session_dir)


def test_transformers_trainer_tiny(port4, tmp_path):
    """Tiny random-weight transformer fine-tune: metrics must flow from HF
    Trainer logs through session.report back to the driver."""
    from ray_tpu_torch.train.huggingface import TransformersTrainer

    out_dir = str(tmp_path / "hf_out")

    def loop(config):
        import os

        # transformers imports TensorFlow and jax for backends this loop
        # never uses (~18 s of a ~40 s import here, and jax into a port
        # worker): torch only
        os.environ["USE_TF"] = "0"
        os.environ["USE_FLAX"] = "0"
        import torch
        import transformers

        from ray_tpu_torch.train.huggingface import prepare_trainer

        cfg = transformers.GPT2Config(
            n_layer=1, n_head=2, n_embd=32, vocab_size=128,
            n_positions=32)
        model = transformers.GPT2LMHeadModel(cfg)

        class DS(torch.utils.data.Dataset):
            def __len__(self):
                return 16

            def __getitem__(self, i):
                ids = torch.randint(0, 128, (16,))
                return {"input_ids": ids, "labels": ids}

        args = transformers.TrainingArguments(
            output_dir=config["out_dir"], num_train_epochs=1,
            per_device_train_batch_size=4, logging_steps=1,
            report_to=[], max_steps=3, use_cpu=True,
            disable_tqdm=True)
        trainer = transformers.Trainer(model=model, args=args,
                                       train_dataset=DS())
        trainer = prepare_trainer(trainer)
        trainer.train()

    t = TransformersTrainer(loop, train_loop_config={"out_dir": out_dir},
                            scaling_config=CPU1)
    result = t.fit()
    assert result.error is None, result.error
    assert result.metrics is not None
    assert "loss" in result.metrics or "train_loss" in result.metrics


def test_accelerate_trainer_tiny(port4):
    """Tiny model trained through accelerate.Accelerator on one worker."""
    from ray_tpu_torch.train.accelerate import AccelerateTrainer

    def loop(config):
        import torch
        from accelerate import Accelerator

        from ray_tpu_torch import train

        acc = Accelerator(cpu=True)
        model = torch.nn.Linear(4, 1)
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        model, opt = acc.prepare(model, opt)
        x = torch.randn(64, 4)
        y = x.sum(dim=1, keepdim=True)
        for _ in range(10):
            loss = torch.nn.functional.mse_loss(model(x), y)
            acc.backward(loss)
            opt.step()
            opt.zero_grad()
        train.report({"loss": float(loss)})

    result = AccelerateTrainer(loop, scaling_config=CPU1).fit()
    assert result.error is None, result.error
    assert result.metrics["loss"] < 5.0


def _has(lib):
    try:
        __import__(lib)
        return True
    except ImportError:
        return False


def _gate_message(make):
    with pytest.raises(ImportError) as e:
        make()
    return str(e.value)


def test_lightning_trainer_gated():
    import ray_tpu.train as jtrain
    from ray_tpu_torch.train import LightningTrainer

    if _has("lightning"):
        pytest.skip("lightning installed; gate not applicable")
    got = _gate_message(lambda: LightningTrainer(lambda c: None))
    want = _gate_message(lambda: jtrain.LightningTrainer(lambda c: None))
    assert "lightning" in got
    # the reference's text, less its pointer to the JAX trainer
    assert got == want.replace(", or JaxTrainer on TPU", "")


def test_gbdt_trainers_gated():
    import ray_tpu.train as jtrain
    from ray_tpu_torch.train import LightGBMTrainer, XGBoostTrainer

    checked = 0
    for lib, port_cls, ref_cls in (
            ("xgboost", XGBoostTrainer, jtrain.XGBoostTrainer),
            ("lightgbm", LightGBMTrainer, jtrain.LightGBMTrainer)):
        if _has(lib):
            continue
        got = _gate_message(lambda: port_cls(datasets={}, label_column="y"))
        want = _gate_message(lambda: ref_cls(datasets={}, label_column="y"))
        assert lib in got
        assert got == want.replace("JaxTrainer/TorchTrainer", "TorchTrainer")
        checked += 1
    if not checked:
        pytest.skip("xgboost and lightgbm installed; gates not applicable")


def test_train_names_match_jax():
    import ray_tpu.train as jtrain
    import ray_tpu_torch.train as ttrain

    ported = {"JaxTrainer": "TorchTrainer", "JaxConfig": "TorchConfig",
              "JaxPredictor": "ParamsPredictor"}
    want = sorted(ported.get(n, n) for n in jtrain.__all__)
    assert sorted(ttrain.__all__) == want
    for name in ttrain.__all__:
        assert getattr(ttrain, name) is not None
