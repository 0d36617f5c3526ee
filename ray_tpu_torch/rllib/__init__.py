"""ray_tpu_torch.rllib — the RL core of ``ray_tpu.rllib`` on PyTorch: RL
modules (functional params and forward), the model catalog, the learners
(PPO's loss, ``clip_adam``, the data mesh) and the learner group. The
algorithms, env runners and connectors are not ported yet."""

from ray_tpu_torch.rllib.core.learner import Learner, PPOLearner
from ray_tpu_torch.rllib.core.learner_group import LearnerGroup
from ray_tpu_torch.rllib.core.rl_module import MLPModule, RLModuleSpec

__all__ = ["Learner", "LearnerGroup", "MLPModule", "PPOLearner",
           "RLModuleSpec"]
