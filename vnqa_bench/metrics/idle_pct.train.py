"""The share of the traced window in which no operation ran on the card (the
union of the profiler's device intervals, against the window's length)."""


def read(rec):
    window = rec.get("window_s")
    if not window:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / window)
