# Copied from ray_tpu/rllib/offline/__init__.py (ray_tpu -> ray_tpu_torch).
from ray_tpu_torch.rllib.offline.estimators import (
    DirectMethod, DoublyRobust, ImportanceSampling,
    WeightedImportanceSampling)
from ray_tpu_torch.rllib.offline.json_io import JsonReader, JsonWriter

__all__ = ["JsonReader", "JsonWriter", "ImportanceSampling",
           "WeightedImportanceSampling", "DirectMethod", "DoublyRobust"]
