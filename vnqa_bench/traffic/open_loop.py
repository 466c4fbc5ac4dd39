"""Open-loop serving: independent users send single requests at Poisson
arrivals of one fixed rate to an in-process ``MicroBatcher``, from a pool of
sender threads (``submit`` blocks until the answer). Each request is timed
from when it was due to be sent until its probabilities returned; a refused
or failed request counts in ``failed``. The arrival gaps are the quantile
midpoints of the exponential distribution, in the seed's order, so every
seed offers the same load."""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np
import torch

from vnqa_bench import inputs, serving
from vnqa_bench.trace import Window

WARM_UP_S = 2.0


def arrivals(rate, seconds, seed):
    """Due times (s from the window's start) of round(rate x seconds) requests."""
    n = max(1, round(rate * seconds))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    gaps = gaps[inputs.rng_for(seed, 30).permutation(n)]
    return np.cumsum(gaps) - gaps[0]


def percentile(values, p):
    """The p-th percentile (nearest rank) of ``values``."""
    v = np.sort(np.asarray(values))
    return float(v[min(len(v) - 1, max(0, int(np.ceil(p / 100 * len(v))) - 1))])


class Recorder:
    """Wraps the engine's dispatch_batch to note which requests each batch held."""

    def __init__(self, eng):
        self.eng = eng
        self.request_of = {}      # id of a request's tokens object -> its number
        self.batches = []
        self.window = None
        self.inner, self.inner_fetch = eng.dispatch_batch, eng.fetch
        eng.dispatch_batch = self
        eng.fetch = self.fetch

    def __call__(self, items):
        with self.window.span("dispatch_batch"):
            handle = self.inner(items)
        self.batches.append(([self.request_of.get(id(it[2])) for it in items],
                             self.eng.bucket_for(max(int(it[1]) for it in items))))
        return handle

    def fetch(self, handle):
        with self.window.span("fetch"):
            return self.inner_fetch(handle)


def run(ctx):
    from videonavqa_tpu_torch.serve.batcher import MicroBatcher

    cell, dev = ctx.cell, ctx.device
    B = cell["batch"]
    pool = serving.Pool(ctx, video=False)
    weights = serving.make_weights(ctx)
    buckets = tuple(cell["frame_buckets"])
    eng = serving.build_engine(ctx, weights, frame_buckets=buckets)
    # set-up: the int8 calibration on the first batch of the pool, then one
    # batch at every frame bucket
    calib = list(range(B))
    calib_T = eng.bucket_for(max(int(pool.v_len[i]) for i in calib))
    eng.run_batch([pool.item(i) for i in calib])
    by_len = np.argsort(pool.v_len)
    for t in buckets:
        i = int(by_len[np.searchsorted(pool.v_len[by_len], min(t, int(pool.v_len.max())))])
        eng.run_batch([pool.item(i)])
    batcher = MicroBatcher(eng, batch_wait_ms=cell["batch_wait_ms"],
                           max_pending=cell["max_pending"], pipeline_depth=cell["pipeline_depth"])
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    recorder = Recorder(eng)
    rates = ctx.rates or [cell["rate"]]
    senders = ThreadPoolExecutor(max_workers=cell["senders"])
    gate = threading.Barrier(cell["senders"] + 1)      # start every sender thread now
    for _ in range(cell["senders"]):
        senders.submit(gate.wait)
    gate.wait()
    # set-up ends with a short untraced burst at the first rate, which fills
    # the engine's caches of pinned host buffers at the window's concurrency
    offer(ctx, batcher, pool, rates[0], WARM_UP_S, senders, sync, recorder, start_k=-1,
          traced=False)
    ctx.setup_done()

    for r, rate in enumerate(rates):
        before = dict(batcher.stats)
        w, lat, late, results, failed, order = offer(
            ctx, batcher, pool, rate, ctx.seconds, senders, sync, recorder, start_k=r * 7919)
        after = dict(batcher.stats)
        done = lat[~np.isnan(lat)]
        p95 = percentile(done * 1e3, 95) if len(done) else float("nan")
        thirds = np.array_split(lat, 3)
        ctx.note(f"rate {rate:g}/s: {len(lat)} requests, {len(done)} answered, {failed} failed,"
                 f" p50 {percentile(done * 1e3, 50):.2f} ms, p95 {p95:.2f} ms,"
                 f" p50 by thirds {[round(float(np.nanmedian(t)) * 1e3, 2) for t in thirds]},"
                 f" window {w.seconds:.3f} s for {ctx.seconds:g} s of arrivals,"
                 f" generator late p95 {percentile(late * 1e3, 95):.3f} ms,"
                 f" batches {after['batches'] - before['batches']},"
                 f" rows {after['requests'] - before['requests']}")
    # the last rate's window is the run's
    batches = list(recorder.batches)
    senders.shutdown()
    batcher.close()
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    ctx.rec["batch_rows"] = (after["requests"] - before["requests"],
                             after["batches"] - before["batches"])
    del eng, batcher, recorder
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the check: every answered request of a sample of the window's batches
    full = [(reqs, T) for reqs, T in batches if reqs and all(k in results for k in reqs)]
    rng = inputs.rng_for(ctx.seed, 20)
    picked = [full[i] for i in serving.sample(rng, len(full), cell["check_batches"])]
    checker = serving.Checker(ctx, pool, weights, calib, calib_T)
    compared, ref_s = checker.compare(
        [([order[k] for k in reqs], T, np.stack([results[k] for k in reqs]), None)
         for reqs, T in picked])
    ctx.note(f"reference over {sum(len(r) for r, _ in picked)} requests in"
             f" {len(picked)} batches in {ref_s:.1f} s")
    return {"metrics": {"serve_p95_ms": p95}, "attempted": len(lat), "failed": failed,
            "correct": bool(picked) and all(v <= lim for v, lim in compared.values()),
            "compared": compared, "memory_peak_bytes": memory_peak, "trace": w.trace}


def offer(ctx, batcher, pool, rate, seconds, senders, sync, recorder, start_k=0, traced=None):
    """One open-loop window at ``rate``, each request's tokens object registered
    in ``recorder.request_of`` as its name -> (window, latencies, lateness,
    {request: probabilities}, failed, pool index of each request)."""
    due = arrivals(rate, seconds, ctx.seed + start_k)
    n = len(due)
    lat = np.full(n, np.nan)
    late = np.zeros(n)
    results, failed = {}, [0]
    order = [(start_k + k) % pool.n for k in range(n)]
    recorder.batches.clear()
    recorder.request_of.clear()
    items = [pool.item(i) for i in order]
    # each request's tokens are a view object of its own, which names it
    for k, it in enumerate(items):
        recorder.request_of[id(it[2])] = k
    lock = threading.Lock()

    def send(k, t_due):
        late[k] = time.perf_counter() - t_due
        try:
            probs = batcher.submit(*items[k])
        except Exception:
            with lock:
                failed[0] += 1
            return
        lat[k] = time.perf_counter() - t_due
        results[k] = np.array(probs)

    with Window(ctx.traced if traced is None else traced, sync) as w:
        recorder.window = w
        futures = []
        for k in range(n):
            t_due = w.t0 + due[k]
            pause = t_due - time.perf_counter()
            if pause > 0:
                time.sleep(pause)
            futures.append(senders.submit(send, k, t_due))
        wait(futures, timeout=seconds + 60)
        w.close()
    return w, lat, late, results, failed[0], order
