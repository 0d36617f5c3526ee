# Ported from ray_tpu/rllib/algorithms/ddppo/ddppo.py (ray_tpu -> ray_tpu_torch).
"""DD-PPO — decentralized distributed PPO (reference:
rllib/algorithms/ddppo/ddppo.py:16: rollout workers compute gradients
locally and allreduce them with no central learner bottleneck).

"Decentralized data parallel" runs at two scales here —

- across PROCESSES: ``num_learners=N`` learner actors each grad their
  batch shard and allreduce through ``ray_tpu_torch.util.collective``
  (NCCL between cards, the host group between CPU learners) before
  applying (params stay bitwise identical; see
  core/learner_group.py _RemoteLearner);
- across RANKS of one learner: with a ``torch.distributed`` group of more
  than one rank up, the learner's update runs on the ``data`` mesh and
  each grad is reduced to its replicated param (core/learner.py). The
  multichip dry run exercises this path (``ray_tpu_torch.dryrun``).
"""

from __future__ import annotations

from ray_tpu_torch.rllib.algorithms.ppo.ppo import PPO, PPOConfig


class DDPPOConfig(PPOConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or DDPPO)
        # decentralized by default: two grad-syncing learner actors
        self.num_learners = 2


class DDPPO(PPO):
    @classmethod
    def get_default_config(cls):
        return DDPPOConfig(algo_class=cls)
