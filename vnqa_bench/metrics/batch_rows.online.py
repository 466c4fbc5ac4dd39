"""Requests per micro-batch over the window: the change in MicroBatcher.stats
'requests' over the change in 'batches'."""


def read(rec):
    requests, batches = rec.get("batch_rows", (0, 0))
    if not batches:
        return None
    return requests / batches
