"""The parts of ``ray_tpu``'s runtime that the port has not copied yet.

The port's copy of the runtime holds what its paths reach. Where a copied
module reaches further through a function-level import, it raises the
error built here instead: the conda and container runtime envs (the agent's
worker setup) and the autoscaler (``cluster_utils.AutoscalingCluster`` and
the CLI's ``up`` and ``down``), which ROADMAP Queue 1 lists among the
modules still to port.
"""

from __future__ import annotations


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"ray_tpu_torch has no port of {what} yet: it is one of the "
        "runtime modules still to port (ROADMAP Queue 1, \"The runtime "
        "modules left out of the copy\")")
