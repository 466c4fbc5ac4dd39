"""Bulk serving: a caller with a queue of videos keeps one batch dispatched
ahead (``InferenceEngine.dispatch_batch`` for batch i+1, then ``fetch`` for
batch i), cycling through the pool in the seed's order. Reports the videos
answered over all the window's time.

The check compares the probabilities of the window's first batch of each of
a few pool batches drawn from the seed and, from video, the stem's features
that the timed path computed for them (kept on the card by a hook on
``InferenceEngine.features`` until the window has closed)."""

from __future__ import annotations

import time

import numpy as np
import torch

from vnqa_bench import inputs, serving
from vnqa_bench.trace import Window


def run(ctx):
    cell, dev = ctx.cell, ctx.device
    B = cell["batch"]
    video = cell["input"] == "video"
    pool = serving.Pool(ctx, video)
    weights = serving.make_weights(ctx)
    eng = serving.build_engine(ctx, weights, frame_buckets=())
    T = inputs.MAX_FRAMES
    n_batches = pool.n // B

    def indices(b):
        b %= n_batches
        return list(range(b * B, (b + 1) * B))

    def items(b):
        return [pool.item(i) for i in indices(b)]

    # set-up: the int8 calibration on the first batch, then the served shape
    eng.run_batch(items(0))
    for b in range(1, 4):
        eng.run_batch(items(b))
    torch.cuda.synchronize(dev) if dev.type == "cuda" else None
    tally = serving.Tally(ctx.model_cfg(), video)
    served, host_s = {}, []
    checked = serving.sample(inputs.rng_for(ctx.seed, 20), n_batches, cell["check_batches"])
    features, current = {}, [None]
    if video:
        stem = eng.features

        def keep_features(batch, cfg=None):
            f = stem(batch, cfg)
            if current[0] in checked and current[0] not in features:
                features[current[0]] = f.detach().clone()
            return f

        eng.features = keep_features
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    ctx.setup_done()

    with Window(ctx.traced, sync) as w:
        b, pending = 0, None
        while True:
            t0 = time.perf_counter()
            current[0] = b % n_batches
            with w.span("dispatch_batch"):
                handle = eng.dispatch_batch(items(b))
            host_s.append(time.perf_counter() - t0)
            if pending is not None:
                pb, ph = pending
                with w.span("fetch"):
                    probs = eng.fetch(ph)
                served.setdefault(pb % n_batches, np.array(probs))
                tally.add(pool, indices(pb), B, T)
            pending = (b, handle)
            b += 1
            if time.perf_counter() - w.t0 >= ctx.seconds:
                break
        pb, ph = pending
        with w.span("fetch"):
            probs = eng.fetch(ph)
        served.setdefault(pb % n_batches, np.array(probs))
        tally.add(pool, indices(pb), B, T)
        w.close()

    videos = tally.videos
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    ctx.note(f"{videos} videos in {videos // B} batches over {w.seconds:.3f} s")
    tally.into(ctx.rec)
    ctx.rec["engine_host_s"] = host_s
    del eng
    if ctx.traced and video:
        ctx.rec["stem_ms"] = serving.stem_ms(ctx, pool, weights, B)
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    picked = [b for b in checked if b in served and (b in features or not video)]
    checker = serving.Checker(ctx, pool, weights, indices(0), T)
    compared, ref_s = checker.compare(
        [(indices(b), T, served[b], features[b].cpu() if video else None) for b in picked])
    del features
    ctx.note(f"reference over {len(picked)} batches in {ref_s:.1f} s")
    return {"metrics": {"serve_videos_per_s": videos / w.seconds}, "attempted": videos,
            "failed": 0,
            "correct": bool(picked) and all(v <= lim for v, lim in compared.values()),
            "compared": compared, "memory_peak_bytes": memory_peak, "trace": w.trace}
