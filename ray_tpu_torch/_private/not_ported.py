"""The parts of ``ray_tpu``'s runtime that the port has not copied yet.

The port's copy of the runtime holds what the Serve path reaches. Where a
copied module reaches further through a function-level import, it raises
the error built here instead, naming the ROADMAP item that ports the rest.
"""

from __future__ import annotations


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"ray_tpu_torch has no port of {what} yet: it is one of the "
        "runtime modules still to port (ROADMAP Queue 1, \"The runtime "
        "modules left out of the copy\")")
