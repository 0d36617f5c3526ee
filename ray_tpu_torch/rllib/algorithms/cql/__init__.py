# Copied from ray_tpu/rllib/algorithms/cql/__init__.py (ray_tpu -> ray_tpu_torch).
from ray_tpu_torch.rllib.algorithms.cql.cql import CQL, CQLConfig

__all__ = ["CQL", "CQLConfig"]
