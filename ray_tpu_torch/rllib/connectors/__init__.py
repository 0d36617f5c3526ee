# Copied from ray_tpu/rllib/connectors/__init__.py (ray_tpu -> ray_tpu_torch).
from ray_tpu_torch.rllib.connectors.connector import (
    ActionClip, Connector, ConnectorPipeline, FlattenObs, FrameStack,
    NormalizeObs)

__all__ = ["Connector", "ConnectorPipeline", "NormalizeObs", "FrameStack",
           "FlattenObs", "ActionClip"]
