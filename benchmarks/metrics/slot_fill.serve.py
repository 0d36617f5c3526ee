"""slot_fill.serve: live rows over dispatched rows in the window, from the
engine's counters: d(emitted) / (d(emitted) + d(padded_slots))."""


def read(r):
    emitted = r["stats1"]["emitted"] - r["stats0"]["emitted"]
    padded = r["stats1"]["padded_slots"] - r["stats0"]["padded_slots"]
    if emitted + padded <= 0:
        return None
    return 100.0 * emitted / (emitted + padded)
