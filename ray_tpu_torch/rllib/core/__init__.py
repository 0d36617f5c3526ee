from ray_tpu_torch.rllib.core.learner import Learner, PPOLearner
from ray_tpu_torch.rllib.core.learner_group import LearnerGroup
from ray_tpu_torch.rllib.core.rl_module import (
    Categorical, DiagGaussian, MLPModule, RLModuleSpec, rl_params_from_jax)

__all__ = ["Categorical", "DiagGaussian", "Learner", "LearnerGroup",
           "MLPModule", "PPOLearner", "RLModuleSpec", "rl_params_from_jax"]
