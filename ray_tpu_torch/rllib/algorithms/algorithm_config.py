# Ported from ray_tpu/rllib/algorithms/algorithm_config.py (ray_tpu -> ray_tpu_torch).
"""AlgorithmConfig — fluent builder (reference:
rllib/algorithms/algorithm_config.py, 3.5k LoC; ``framework`` :1205. Here
PyTorch is the only framework, so ``framework("torch")`` is the default and
any other raises).

The env's spaces are read by duck typing (a discrete action space has
``n``, a box ``shape``, ``low`` and ``high``), so an env given as a class
or a callable needs no gymnasium; a string env id goes through
``gymnasium.make``. ``learners(device=...)`` places the learners: ``None``
is the CUDA card (it raises without one), the CPU is taken when asked for,
and remote learners take the same device.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional, Tuple, Type, Union


def is_discrete(space) -> bool:
    """A discrete space, by duck typing: it has ``n`` (gymnasium's
    ``Discrete``, or any space that counts its actions) and no ``low``."""
    return hasattr(space, "n") and not hasattr(space, "low")


class AlgorithmConfig:
    def __init__(self, algo_class: Optional[type] = None):
        self.algo_class = algo_class
        # environment
        self.env: Optional[Union[str, Callable]] = None
        self.env_config: Dict = {}
        # env runners
        self.num_env_runners = 2
        self.num_envs_per_env_runner = 4
        self.rollout_fragment_length = 64
        self.explore = True
        # training
        self.gamma = 0.99
        self.lr = 3e-4
        self.train_batch_size = 2048
        self.minibatch_size = 128
        self.num_epochs = 4
        self.grad_clip = 0.5
        self.seed = 0
        # learners
        self.num_learners = 0
        self.resources_per_learner: Optional[Dict] = None
        self.learner_device: Optional[str] = None  # None: the CUDA card
        # model
        self.model: Dict = {"hiddens": (64, 64), "activation": "tanh"}
        # framework (always torch; kept for API parity)
        self.framework_str = "torch"
        # fault tolerance (reference: restart_failed_env_runners)
        self.restart_failed_env_runners = True
        # obs/action connector pipeline (reference: rllib/connectors/)
        self.connector = None

    # ------------------------------------------------------- fluent setters
    def environment(self, env=None, *, env_config: Optional[Dict] = None
                    ) -> "AlgorithmConfig":
        if env is not None:
            self.env = env
        if env_config is not None:
            self.env_config = env_config
        return self

    def env_runners(self, *, num_env_runners: Optional[int] = None,
                    num_envs_per_env_runner: Optional[int] = None,
                    rollout_fragment_length: Optional[int] = None,
                    explore: Optional[bool] = None,
                    connector=None) -> "AlgorithmConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_env_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        if explore is not None:
            self.explore = explore
        if connector is not None:
            self.connector = connector
        return self

    def training(self, **kwargs) -> "AlgorithmConfig":
        for k, v in kwargs.items():
            if not hasattr(self, k) and k not in self._training_keys():
                raise ValueError(f"unknown training key {k!r}")
            setattr(self, k, v)
        return self

    def _training_keys(self):
        return set()

    def learners(self, *, num_learners: Optional[int] = None,
                 resources_per_learner: Optional[Dict] = None,
                 device: Optional[str] = None) -> "AlgorithmConfig":
        """``device``: the learners' (``"cpu"``, ``"cuda"``, ...); unset it
        stays None, the CUDA card."""
        if num_learners is not None:
            self.num_learners = num_learners
        if resources_per_learner is not None:
            self.resources_per_learner = resources_per_learner
        if device is not None:
            self.learner_device = device
        return self

    def framework(self, framework: str = "torch") -> "AlgorithmConfig":
        if framework != "torch":
            raise ValueError(
                "this build is PyTorch/CUDA-native; framework must be "
                "'torch'")
        self.framework_str = framework
        return self

    def fault_tolerance(self, *, restart_failed_env_runners: Optional[bool]
                        = None) -> "AlgorithmConfig":
        if restart_failed_env_runners is not None:
            self.restart_failed_env_runners = restart_failed_env_runners
        return self

    def rl_module(self, *, model: Optional[Dict] = None) -> "AlgorithmConfig":
        if model:
            self.model.update(model)
        return self

    def debugging(self, *, seed: Optional[int] = None) -> "AlgorithmConfig":
        if seed is not None:
            self.seed = seed
        return self

    # --------------------------------------------------------------- build
    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    def to_dict(self) -> Dict:
        return {k: v for k, v in self.__dict__.items()
                if k != "algo_class"}

    def build(self, use_tune_dirs: bool = False):
        if self.algo_class is None:
            raise ValueError("config has no algo_class; use PPOConfig() etc.")
        return self.algo_class(config=self)

    # ------------------------------------------------------------ env utils
    def make_env(self) -> Callable:
        env = self.env
        env_config = self.env_config
        if callable(env):
            return lambda: env(env_config)
        if isinstance(env, str):
            def creator():  # needs gymnasium
                import gymnasium as gym

                return gym.make(env, **env_config)

            return creator
        raise ValueError(f"unsupported env spec {env!r}")

    def module_spec(self):
        from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec

        probe = self.make_env()()
        try:
            obs_space = probe.observation_space
            act_space = probe.action_space
            # catalog routing (reference: models/catalog.py get_model_v2):
            # rank-3 obs -> ConvModule; model={'use_lstm': True} -> LSTM
            obs_shape = (tuple(obs_space.shape)
                         if len(obs_space.shape) == 3 else None)
            obs_dim = (int(obs_space.shape[0]) if obs_shape is None else 0)
            if self.connector is not None and obs_shape is None:
                # FrameStack-style connectors widen the feature dim
                # (pipelines expose obs_multiplier; bare connectors
                # obs_dim_multiplier)
                obs_dim *= getattr(
                    self.connector, "obs_multiplier",
                    getattr(self.connector, "obs_dim_multiplier", 1))
            common = dict(
                hiddens=tuple(self.model.get("hiddens", (64, 64))),
                activation=self.model.get("activation", "tanh"),
                obs_shape=obs_shape,
                conv_filters=self.model.get("conv_filters"),
                use_lstm=bool(self.model.get("use_lstm", False)),
                lstm_cell_size=int(self.model.get("lstm_cell_size", 64)))
            if is_discrete(act_space):
                return RLModuleSpec(
                    obs_dim=obs_dim, action_dim=int(act_space.n),
                    discrete=True, **common)
            return RLModuleSpec(
                obs_dim=obs_dim, action_dim=int(act_space.shape[0]),
                discrete=False, **common)
        finally:
            probe.close()

    def resources_for_learners(self) -> Optional[Dict]:
        """Each remote learner's resources: as configured, else one GPU for
        a learner on the card and one CPU for a learner on the CPU."""
        if self.resources_per_learner is not None:
            return self.resources_per_learner
        if self.learner_device is None or \
                str(self.learner_device).startswith("cuda"):
            return {"CPU": 1, "GPU": 1}
        return {"CPU": 1}

    def learner_config_dict(self) -> Dict:
        return {
            "lr": self.lr, "grad_clip": self.grad_clip,
            "num_epochs": self.num_epochs,
            "minibatch_size": self.minibatch_size, "seed": self.seed,
            "gamma": self.gamma,  # TD/V-trace targets must match rollouts
        }
