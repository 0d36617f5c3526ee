"""ray_tpu_torch.parallel — the mesh, the sharding rules and the train step
(port of ``ray_tpu.parallel``): a ``DeviceMesh`` over the process group's
ranks, logical axes placed as DTensors, and the step on one device or on a
mesh."""

from ray_tpu_torch.parallel.mesh import (
    AXIS_ORDER, MeshConfig, best_mesh_shape, create_mesh, local_mesh)
from ray_tpu_torch.parallel.optim import adafactor, adamw, clip_adam
from ray_tpu_torch.parallel.sharding import (
    DEFAULT_RULES, NamedSharding, PartitionSpec, ambient_mesh,
    compat_mesh_ctx, compat_shard_map, constrain, logical_to_spec, param_shardings, shard_pytree, spec_to_placements)
from ray_tpu_torch.parallel.train_step import (
    TrainState, create_train_state, load_train_state, make_eval_step,
    make_train_step, train_state_tree)

__all__ = ["AXIS_ORDER", "DEFAULT_RULES", "MeshConfig", "NamedSharding",
           "PartitionSpec", "TrainState", "adafactor", "adamw", "clip_adam",
           "ambient_mesh", "best_mesh_shape", "compat_mesh_ctx",
           "compat_shard_map", "constrain", "create_mesh",
           "create_train_state", "load_train_state",
           "local_mesh", "logical_to_spec", "make_eval_step",
           "make_train_step", "param_shardings", "shard_pytree",
           "spec_to_placements", "train_state_tree"]
