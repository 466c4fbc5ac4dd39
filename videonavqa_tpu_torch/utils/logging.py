"""Observability: JSONL metrics, an optional profiler trace, step timing (the
counterpart of the JAX package's utils/logging.py).

``MetricsLogger`` writes the same events with the same fields as the JAX
harness: ``run_start`` (the model and the arguments), ``train_progress``,
``train_epoch`` and ``eval_epoch``, one JSON object a line. ``maybe_profile``
traces its block with torch.profiler into a directory (a Chrome trace), and
``StepTimer`` times steps by the host clock after a CUDA synchronize.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import numpy as np
import torch


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


class StepTimer:
    """Step times by the host clock, the device synchronized at ``stop``,
    the first ``skip`` steps left out of the mean."""

    def __init__(self, skip=2):
        self.skip = skip
        self.count = 0
        self.total = 0.0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, device=None):
        """Seconds since ``start``; waits for ``device``'s work first when it
        is a CUDA device."""
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - self._t0
        self.count += 1
        if self.count > self.skip:
            self.total += dt
        return dt

    @property
    def mean_ms(self):
        return 1000.0 * self.total / max(self.count - self.skip, 1)
