"""engine_step_ms.serve: the window's length over the engine's steps in it
(``engine.stats()["steps"]`` read through the handle before and after)."""


def read(r):
    steps = r["stats1"]["steps"] - r["stats0"]["steps"]
    if steps <= 0:
        return None
    return r["window_s"] / steps * 1e3
