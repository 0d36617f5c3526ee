from ray_tpu_torch.util.collective.collective_group.base_group import BaseGroup
from ray_tpu_torch.util.collective.collective_group.cpu_group import CPUGroup

__all__ = ["BaseGroup", "CPUGroup", "NCCLGroup"]


def __getattr__(name):
    # NCCLGroup imports torch: loaded when asked for, so that the host
    # group's members (numpy only) never import it
    if name == "NCCLGroup":
        from ray_tpu_torch.util.collective.collective_group.nccl_group import (
            NCCLGroup)
        return NCCLGroup
    raise AttributeError(name)
