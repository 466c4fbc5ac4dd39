"""The work the window completed as a share of the card's peak: the least
time of every video's operations (the yardstick's count from the
configuration's shapes, each part at the peak of the precision the
configuration states for it) over the traced window's time."""


def read(rec):
    least, window = rec.get("model_least_s"), rec.get("window_s")
    if not least or not window:
        return None
    return 100.0 * least / window
