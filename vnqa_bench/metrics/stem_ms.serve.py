"""Device milliseconds of the measured package's stem_features on one batch of
the cell's shapes, by CUDA events, outside the window."""


def read(rec):
    return rec.get("stem_ms")
