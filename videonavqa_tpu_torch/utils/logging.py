"""Observability: JSONL metrics, an optional profiler trace (the counterparts
of the JAX package's utils/logging.py), and the program's own spans and
counters.

``MetricsLogger`` writes the same events with the same fields as the JAX
harness: ``run_start`` (the model and the arguments), ``train_progress``,
``train_epoch`` and ``eval_epoch``, one JSON object a line. ``maybe_profile``
traces its block with torch.profiler into a directory (a Chrome trace).

Spans. Tracing is off unless ``trace_on()`` turns it on; off, ``span``
returns one shared no-op context after a single check of a module flag (no
clock read, no lock, no allocation) and ``wait_span`` returns at once. On,
each thread appends to a list of its own (a lock is taken only the first
time a thread records) one span per ``with span(name, ...)``: its name, its
thread's name, its start and end in ``time.time_ns()`` nanoseconds (the
host clock that torch.profiler's device events carry), an id, the id of
the span open around it on the same thread, and the caller's ids: ``batch``
for the spans of one micro-batch (a span given none takes the one of the
span around it), ``request`` for one request. ``device=True`` also records a
pair of timing CUDA events on the current stream where CUDA is in use; they
are resolved to ``device_ms`` when the record is drained, after the caller
has synchronised. ``wait_span`` records a wait that one thread started
(``start_ns``, its ``time.time_ns()``) and another ends, marked ``wait``.
``trace_drain()`` returns ``{"spans": [...], "counters": {...}}`` and
clears the record; the counters are growths since ``trace_on()`` or the last
drain: ``conv3x3_int8.launches``, the launches of the int8 trunk's 3x3 conv
kernel (6 a film_attn_pt forward at 5 blocks; 0 on the CPU), and, from
``torch.cuda.host_memory_stats`` where the build reports them, the pinned
host pool's (``pinned.allocs``: cudaHostAlloc calls; ``pinned.alloc_ms``:
their time).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time

import numpy as np
import torch

from videonavqa_tpu_torch.kernels import conv3x3_int8


class MetricsLogger:
    """Append-only JSONL event log; a no-op when ``path`` is None."""

    def __init__(self, path=None, run_meta=None):
        self.path = path
        self._f = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a", buffering=1)
            if run_meta:
                self.log("run_start", **run_meta)

    def log(self, event, **fields):
        if self._f is None:
            return
        rec = {"event": event, "time": time.time()}
        rec.update(fields)
        self._f.write(json.dumps(rec, default=_jsonify) + "\n")

    def close(self):
        if self._f:
            self._f.close()
            self._f = None


def _jsonify(x):
    if isinstance(x, (np.integer, np.floating)):
        return x.item()
    if isinstance(x, np.ndarray):
        return x.tolist()
    return str(x)


@contextlib.contextmanager
def maybe_profile(trace_dir=None):
    """A torch.profiler trace of the block (CPU, and CUDA where there is a
    card) written into ``trace_dir`` when it is given; else a no-op."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, f"trace_{os.getpid()}.json"))


# --- spans and counters --------------------------------------------------------

_on = False
_NO_SPAN = contextlib.nullcontext()
_local = threading.local()      # .buf: this thread's _Buffer
_buffers = []                   # every recording thread's _Buffer
_buffers_lock = threading.Lock()
_ids = itertools.count(1)
_pinned_base = None
_conv3x3_base = 0


class _Buffer:
    """One thread's record: its finished spans and its open ones."""

    __slots__ = ("owner", "thread", "spans", "stack")

    def __init__(self):
        self.owner = threading.current_thread()
        self.thread = self.owner.name
        self.spans = []   # (name, start_ns, end_ns, id, parent, batch, request, events, wait)
        self.stack = []   # the open _Spans, innermost last


def _buffer():
    buf = getattr(_local, "buf", None)
    if buf is None:
        buf = _local.buf = _Buffer()
        with _buffers_lock:
            _buffers.append(buf)
    return buf


class _Span:
    __slots__ = ("name", "batch", "request", "device", "events", "start", "id", "parent", "buf")

    def __init__(self, name, batch, request, device):
        self.name, self.batch, self.request, self.device = name, batch, request, device
        self.events = None

    def __enter__(self):
        buf = self.buf = _buffer()
        outer = buf.stack[-1] if buf.stack else None
        self.parent = outer.id if outer is not None else None
        if self.batch is None and outer is not None:
            self.batch = outer.batch
        self.id = next(_ids)
        if self.device and torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        buf.stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.events is not None:
            self.events[1].record()
        buf = self.buf
        buf.stack.pop()
        buf.spans.append((self.name, self.start, end, self.id, self.parent, self.batch,
                          self.request, self.events, False))
        return False


def tracing():
    """Whether spans are being recorded."""
    return _on


def span(name, *, batch=None, request=None, device=False):
    """A context that records one span while tracing is on (see the module)."""
    if not _on:
        return _NO_SPAN
    return _Span(name, batch, request, device)


def wait_span(name, start_ns, *, batch=None, request=None):
    """Record a wait from ``start_ns`` (``time.time_ns()``, taken on any
    thread) to now, on this thread, while tracing is on."""
    if not _on:
        return
    _buffer().spans.append((name, start_ns, time.time_ns(), next(_ids), None, batch, request,
                            None, True))


def current_batch():
    """The ``batch`` of the innermost span open on this thread (None when
    tracing is off or there is none)."""
    if not _on:
        return None
    buf = getattr(_local, "buf", None)
    return buf.stack[-1].batch if buf is not None and buf.stack else None


def _pinned():
    """(cudaHostAlloc calls, their ms) of the pinned host pool so far, or None."""
    if not (torch.cuda.is_available() and hasattr(torch.cuda, "host_memory_stats")):
        return None
    stats = torch.cuda.host_memory_stats()
    if "num_host_alloc" not in stats:
        return None
    return stats["num_host_alloc"], stats.get("host_alloc_time.total", 0) / 1e3


def trace_on():
    """Start a new record (what an earlier one left undrained is dropped)."""
    global _on, _pinned_base, _conv3x3_base
    with _buffers_lock:
        for buf in _buffers:
            buf.spans = []
    _pinned_base = _pinned()
    _conv3x3_base = conv3x3_int8.launches
    _on = True


def trace_off():
    global _on
    _on = False


def trace_drain():
    """The record so far -> ``{"spans": [dict, ...] by start, "counters":
    {name: value}}``, and a new record begins."""
    global _pinned_base, _conv3x3_base
    with _buffers_lock:
        buffers = list(_buffers)
        _buffers[:] = [b for b in _buffers if b.owner.is_alive()]
    spans = []
    for buf in buffers:
        done, buf.spans = buf.spans, []
        for name, start, end, sid, parent, batch, request, events, wait in done:
            rec = {"name": name, "thread": buf.thread, "start_ns": start, "end_ns": end,
                   "id": sid, "parent": parent}
            if batch is not None:
                rec["batch"] = batch
            if request is not None:
                rec["request"] = request
            if events is not None:
                events[1].synchronize()
                rec["device_ms"] = events[0].elapsed_time(events[1])
            if wait:
                rec["wait"] = True
            spans.append(rec)
    spans.sort(key=lambda r: r["start_ns"])
    launched = conv3x3_int8.launches
    counters = {"conv3x3_int8.launches": launched - _conv3x3_base}
    _conv3x3_base = launched
    now = _pinned()
    if now is not None:
        base = _pinned_base or (0, 0.0)
        counters.update({"pinned.allocs": now[0] - base[0], "pinned.alloc_ms": now[1] - base[1]})
    _pinned_base = now
    return {"spans": spans, "counters": counters}
