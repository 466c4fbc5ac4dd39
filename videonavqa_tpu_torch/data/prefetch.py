"""Feeding the device: decode ahead on the host, copy one batch ahead.

``host_prefetch`` drains a (CPU-bound) loader into a bounded queue from a
background thread, so decoding overlaps the steps; the native VNR loader
releases the GIL while it decodes. ``device_prefetch`` copies the next batch
to the card while the current step runs: each host tensor goes to pinned
memory and is copied with ``non_blocking=True`` on a side CUDA stream, and an
event marks the end of each batch's copies. Before a batch is handed out,
the current stream waits on its event (a ``wait_stream`` on the side stream
would also wait for the copies of the batches behind it), and each device
tensor is marked as used on the current stream (``record_stream``), so the
allocator does not hand its memory out again while the step still reads
it. On the CPU a batch is moved with a plain ``.to(device)``.
"""

from __future__ import annotations

import collections
import queue as queue_mod
import threading

import torch


def host_prefetch(batch_iter, *, depth: int = 2):
    """The items of ``batch_iter``, produced by a background thread up to
    ``depth`` ahead; an error of the producer is raised here."""
    q = queue_mod.Queue(maxsize=depth)
    end = object()

    def produce():
        try:
            for b in batch_iter:
                q.put(b)
            q.put(end)
        except BaseException as e:  # raised again on the consumer's side
            q.put(e)

    threading.Thread(target=produce, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def device_prefetch(batch_iter, prepare, device, *, depth: int = 2):
    """Yields ``(device batch, *rest)`` for each ``prepare(item) -> (dict of
    CPU tensors, *rest)`` of ``batch_iter``, with up to ``depth`` batches'
    copies to ``device`` in flight."""
    device = torch.device(device)
    side = torch.cuda.Stream(device) if device.type == "cuda" else None

    def start(item):
        host, *rest = prepare(item)
        if side is None:
            return {k: v.to(device) for k, v in host.items()}, None, rest
        with torch.cuda.stream(side):
            moved = {k: v.pin_memory().to(device, non_blocking=True) for k, v in host.items()}
            copied = torch.cuda.Event()
            copied.record(side)
        return moved, copied, rest

    def finish(moved, copied):
        if copied is not None:
            current = torch.cuda.current_stream(device)
            current.wait_event(copied)
            for t in moved.values():
                t.record_stream(current)
        return moved

    pending = collections.deque()
    end = object()
    it = iter(batch_iter)
    for item in it:
        pending.append(start(item))
        if len(pending) >= depth:
            break
    while pending:
        moved, copied, rest = pending.popleft()
        nxt = next(it, end)
        if nxt is not end:
            pending.append(start(nxt))
        yield (finish(moved, copied), *rest)
