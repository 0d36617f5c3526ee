"""device_idle.train: the share of the traced window in which no kernel or
copy ran on the train worker's card (torch.profiler in the worker)."""


def read(r):
    t = r.get("trace")
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - t["busy_s"] / t["window_s"])
