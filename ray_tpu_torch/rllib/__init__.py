"""ray_tpu_torch.rllib — ``ray_tpu.rllib`` on PyTorch: RL modules
(functional params and forward), the model catalog, the learners (the
losses, ``clip_adam``, the data mesh) and the learner group; the env
runners (CPU actors over the port's own vector env, ``env/vector.py``),
connectors, offline IO and estimators, the replay buffers, V-trace;
``Algorithm`` on the port's Tune ``Trainable``; and every algorithm family
of the reference: the on-policy family (PPO, multi-agent PPO, A2C, DD-PPO,
IMPALA, APPO), the off-policy family (DQN, Ape-X DQN, R2D2, SAC, DDPG and
TD3, CQL), the offline family (BC, MARWIL, CRR), the gradient-free ES and
ARS, the LinUCB and LinTS bandits, the multi-agent QMIX and MADDPG,
AlphaZero and DreamerV3. The learners and their state run on the CUDA card
unless the config asks for the CPU (``AlgorithmConfig.learners(
device="cpu")``); env runners and self-play workers are CPU actors, and
ES's and ARS's params live in the driver.
"""

from ray_tpu_torch.rllib.algorithms import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.a2c import A2C, A2CConfig
from ray_tpu_torch.rllib.algorithms.alpha_zero import (
    AlphaZero, AlphaZeroConfig)
from ray_tpu_torch.rllib.algorithms.apex import ApexDQN, ApexDQNConfig
from ray_tpu_torch.rllib.algorithms.appo import APPO, APPOConfig
from ray_tpu_torch.rllib.algorithms.ars import ARS, ARSConfig
from ray_tpu_torch.rllib.algorithms.bandit import (
    BanditLinTS, BanditLinTSConfig, BanditLinUCB, BanditLinUCBConfig)
from ray_tpu_torch.rllib.algorithms.bc import BC, BCConfig
from ray_tpu_torch.rllib.algorithms.cql import CQL, CQLConfig
from ray_tpu_torch.rllib.algorithms.crr import CRR, CRRConfig
from ray_tpu_torch.rllib.algorithms.ddpg import (
    DDPG, DDPGConfig, TD3, TD3Config)
from ray_tpu_torch.rllib.algorithms.ddppo import DDPPO, DDPPOConfig
from ray_tpu_torch.rllib.algorithms.dqn import DQN, DQNConfig
from ray_tpu_torch.rllib.algorithms.dreamerv3 import (
    DreamerV3, DreamerV3Config)
from ray_tpu_torch.rllib.algorithms.es import ES, ESConfig
from ray_tpu_torch.rllib.algorithms.impala import IMPALA, IMPALAConfig
from ray_tpu_torch.rllib.algorithms.maddpg import MADDPG, MADDPGConfig
from ray_tpu_torch.rllib.algorithms.marwil import MARWIL, MARWILConfig
from ray_tpu_torch.rllib.algorithms.ppo import (
    MultiAgentPPO, MultiAgentPPOConfig, PPO, PPOConfig)
from ray_tpu_torch.rllib.algorithms.qmix import QMIX, QMIXConfig
from ray_tpu_torch.rllib.algorithms.r2d2 import R2D2, R2D2Config
from ray_tpu_torch.rllib.algorithms.sac import SAC, SACConfig
from ray_tpu_torch.rllib.core.learner import Learner, PPOLearner
from ray_tpu_torch.rllib.core.learner_group import LearnerGroup
from ray_tpu_torch.rllib.core.rl_module import MLPModule, RLModuleSpec
from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner
from ray_tpu_torch.rllib.env.multi_agent_env import (
    MultiAgentEnv, MultiAgentEnvRunner)
from ray_tpu_torch.rllib.env.policy_client import PolicyClient
from ray_tpu_torch.rllib.env.policy_server_input import PolicyServerInput

__all__ = [
    "Algorithm", "AlgorithmConfig", "PPO", "PPOConfig", "DDPPO",
    "DDPPOConfig", "A2C", "A2CConfig", "APPO", "APPOConfig", "IMPALA",
    "IMPALAConfig", "Learner", "PPOLearner", "LearnerGroup", "MLPModule",
    "RLModuleSpec", "SingleAgentEnvRunner", "MultiAgentEnv",
    "MultiAgentEnvRunner", "MultiAgentPPO", "MultiAgentPPOConfig",
    "PolicyClient", "PolicyServerInput", "DQN", "DQNConfig", "ApexDQN",
    "ApexDQNConfig", "R2D2", "R2D2Config", "SAC", "SACConfig", "DDPG",
    "DDPGConfig", "TD3", "TD3Config", "CQL", "CQLConfig", "BC", "BCConfig",
    "MARWIL", "MARWILConfig", "CRR", "CRRConfig", "ES", "ESConfig", "ARS",
    "ARSConfig", "BanditLinUCB", "BanditLinUCBConfig", "BanditLinTS",
    "BanditLinTSConfig", "QMIX", "QMIXConfig", "MADDPG", "MADDPGConfig",
    "AlphaZero", "AlphaZeroConfig", "DreamerV3", "DreamerV3Config",
]

