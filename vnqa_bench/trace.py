"""The traced window: torch.profiler over the measured window, reduced to device
intervals, per-kernel device time, the idle share and the breakdown.

The profiler records the card's activity alone (kernels, copies, sets):
recording every host operation as well slowed a host-bound train step by a
third. Its timestamps are nanoseconds of the host's real-time clock, so the
window's bounds and the benchmark's own host spans (around each call into
the program) are read from ``time.time_ns()``. Device time is the union of
the intervals in which some operation ran on the card; the idle share is the
rest of the window. An idle gap is named by the innermost benchmark span
covering its middle, on any thread.
"""

from __future__ import annotations

import contextlib
import time

# Substrings of the CUDA kernel names of each kernel of the measured package.
KERNEL_NAMES = {"film_reencode": ("film_reencode_kernel", "film_reencode_wide_kernel"),
                "attn_tail": ("attn_tail_kernel", "attn_tail_context_kernel",
                              "attn_tail_gates_kernel", "attn_tail_wide_kernel"),
                "int8_matmul": ("int8_matmul_kernel", "int8_quantize_kernel"),
                "lstm": ("lstm_h128_cluster_kernel", "lstm_wide_kernel"),
                "vgg_block1": ("vgg_block1_bf16_kernel", "vgg_block1_f32_kernel")}


def union_s(intervals):
    """Seconds covered by the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def gaps(busy, lo, hi):
    """The idle (start, end) intervals of [lo, hi] outside ``busy``."""
    out, t = [], lo
    for a, b in merged(busy):
        if a > t:
            out.append((t, min(a, hi)))
        t = max(t, b)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [g for g in out if g[1] > g[0]]


def cuda_ms(fn, iters=3):
    """Device milliseconds of one ``fn()`` by CUDA events, after one warm call."""
    import torch

    with torch.no_grad():
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_of(name):
    for kernel, subs in KERNEL_NAMES.items():
        if any(s in name for s in subs):
            return kernel
    return None


class Trace:
    """What a traced window recorded, in seconds of the profiler's clock."""

    def __init__(self, device_ops, host_ops, lo, hi):
        self.device_ops = [(n, a, b) for n, a, b in device_ops if b > lo and a < hi]
        self.host_ops = host_ops
        self.lo, self.hi = lo, hi

    @property
    def window_s(self):
        return self.hi - self.lo

    def busy_s(self):
        return union_s([(max(a, self.lo), min(b, self.hi)) for _, a, b in self.device_ops])

    def kernel_s(self):
        """{kernel of KERNEL_NAMES: device seconds} over the window."""
        out = {}
        for n, a, b in self.device_ops:
            k = kernel_of(n)
            if k is not None:
                out[k] = out.get(k, 0.0) + (b - a)
        return out

    def launches(self):
        out = {}
        for n, _, _ in self.device_ops:
            k = kernel_of(n)
            if k is not None:
                out[k] = out.get(k, 0) + 1
        return out

    def breakdown(self, top=10):
        by_name = {}
        for n, a, b in self.device_ops:
            by_name[n] = by_name.get(n, 0.0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(gaps([(a, b) for _, a, b in self.device_ops], self.lo, self.hi),
                      key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": [[self.host_at((a + b) / 2), b - a] for a, b in idle]}

    def host_at(self, t):
        best = None
        for n, a, b in self.host_ops:
            if a <= t <= b and (best is None or b - a < best[2] - best[1]):
                best = (n, a, b)
        return "host: " + (best[0][:100] if best else "outside the benchmark's spans")


def _device_events(prof):
    """(name, start s, end s) of every device operation the profiler saw."""
    import torch

    out = []
    for e in prof.profiler.kineto_results.events():
        if torch.cuda.is_available() and e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
        dur = e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1000
        out.append((e.name(), start * 1e-9, (start + dur) * 1e-9))
    return out


class Window:
    """``with Window(traced) as w:`` times the measured window by the host
    clock and, when traced, profiles it; ``w.trace`` then holds the Trace.
    ``w.span(name)`` times one call into the program as a benchmark span."""

    def __init__(self, traced, sync):
        self.traced = traced
        self.sync = sync
        self.trace = None
        self.spans = []

    @contextlib.contextmanager
    def span(self, name):
        a = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, a * 1e-9, time.time_ns() * 1e-9))

    def __enter__(self):
        self._stack = contextlib.ExitStack()
        if self.traced:
            import torch
            from torch.profiler import ProfilerActivity, profile

            # (a build without CUDA, as in the CPU tests, records host operations)
            activity = ProfilerActivity.CUDA if torch.cuda.is_available() else \
                ProfilerActivity.CPU
            self._prof = self._stack.enter_context(profile(activities=[activity]))
        self.lo = time.time_ns() * 1e-9
        self.t0 = time.perf_counter()
        return self

    def close(self):
        """End the window (the caller has waited for its last result)."""
        self.sync()
        self.t1 = time.perf_counter()
        self.hi = time.time_ns() * 1e-9
        self._stack.close()
        if self.traced:
            self.trace = Trace(_device_events(self._prof), self.spans, self.lo, self.hi)

    def __exit__(self, *exc):
        if not hasattr(self, "t1"):
            self.close() if exc[0] is None else self._stack.close()
        return False

    @property
    def seconds(self):
        return self.t1 - self.t0
