"""optim_ms.train: device time per traced step of the kernels launched
inside torch's ``Optimizer.step#...`` profiler range."""


def read(r):
    t = r.get("trace")
    if not t or not t.get("steps"):
        return None
    s = t["ranges"].get("Optimizer.step")
    if not s:
        return None
    return s / t["steps"] * 1e3
