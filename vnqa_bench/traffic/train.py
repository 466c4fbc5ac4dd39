"""Training from video: ``make_train_step``'s step at the configuration's batch,
fed from host uint8 batches by ``data/prefetch.py device_prefetch`` (pinned,
copied one batch ahead on a side stream), as the training harness feeds it.
Batches are padded to 35 frames; labels are uniform over the classes; each
step's dropout draws from a generator on the card seeded from the seed and
the step. Reports the training videos stepped over all the window's time.

Set-up builds the one train step that the window drives and runs its first
three steps through the window's own feed; the check follows those three
with the plain reference from the same initial weights and batches: each
step's loss, the first step's log-probabilities (kept by a hook on the
model's apply that the step calls), the first gradient as Adam took it and
the parameters' change after the three steps.
"""

from __future__ import annotations

import dataclasses
import functools
import statistics
import time

import numpy as np
import torch

from vnqa_bench import counts, inputs
from vnqa_bench.reference import mac as ref_mac
from vnqa_bench.reference import stem as ref_stem
from vnqa_bench.reference.ops import CONTROLS, REF
from vnqa_bench.trace import Window, cuda_ms

FIRST_STEPS = 3


def host_batches(ctx, cfg):
    """The pool cut into batches of host tensors, in the seed's order."""
    n, B = ctx.pool, ctx.cell["batch"]
    v_len, q_len = inputs.lengths(n, ctx.seed, ctx.cell["mix"])
    tokens = inputs.questions(n, q_len, ctx.seed, cfg["vocab_size"])
    labels = inputs.rng_for(ctx.seed, 5).integers(0, cfg["num_classes"], n)
    video = inputs.videos(n, ctx.seed, ctx.device)
    for i in range(n):
        video[i, int(v_len[i]):] = 0        # the loaders' container is zero past v_len
    out = []
    for b in range(n // B):
        s = slice(b * B, (b + 1) * B)
        out.append({"video": video[s], "question": torch.from_numpy(tokens[s]),
                    "q_len": torch.from_numpy(q_len[s].astype(np.int32)),
                    "v_len": torch.from_numpy(v_len[s].astype(np.int32)),
                    "label": torch.from_numpy(labels[s].astype(np.int64))})
    return out


def step_seed(seed, k):
    return (int(seed) * 7 + 1000 + k) % (1 << 62)


def gap(got, want, scale):
    return abs(got - want) / scale


def leaf_gaps(got, want, keep=None):
    """The worst leaf's |got - want| against the larger of that leaf's and the
    median leaf's reference value (over the leaves ``keep`` marks)."""
    idx = [i for i in range(len(want)) if keep is None or keep[i]]
    med = statistics.median(want[i] for i in idx)
    return max(gap(got[i], want[i], max(want[i], med)) for i in idx)


def run(ctx):
    from videonavqa_tpu_torch.data.prefetch import device_prefetch
    from videonavqa_tpu_torch.models import get_model
    from videonavqa_tpu_torch.models.base import ModelConfig
    from videonavqa_tpu_torch.stem import stem_features
    from videonavqa_tpu_torch.train.step import make_optimizer, make_train_step, tree_leaves

    cell, dev = ctx.cell, ctx.device
    cfg_d = ctx.model_cfg()
    cfg = ModelConfig(**cfg_d)
    B = cell["batch"]
    batches = host_batches(ctx, cfg_d)
    p_shapes, _ = ref_mac.shapes(cfg_d)
    params = inputs.make_weights(p_shapes, ctx.seed, 10, dev)
    det_p, det_s = ref_stem.detector_shapes(cfg_d["num_input_channels"])
    stem = (inputs.make_weights(ref_stem.vgg_shapes(), ctx.seed, 12, dev),
            inputs.make_weights(det_p, ctx.seed, 13, dev),
            inputs.make_weights(det_s, ctx.seed, 14, dev))
    initial = inputs.clone_tree(params, "cpu")
    opts = cell["step"]
    stem_fn = functools.partial(stem_features, *stem, dtype=torch.bfloat16,
                                use_kernel=cfg.use_pallas_kernels and dev.type == "cuda")
    optimizer = make_optimizer(params, opts["l_rate"])
    spec = get_model(cfg.model)
    first = {}

    def apply_keeping_first(*args, **kwargs):
        logits, new_state = spec.apply(*args, **kwargs)
        if "log_probs" not in first:
            first["log_probs"] = torch.log_softmax(logits.detach().float(), dim=-1).cpu()
        return logits, new_state

    step = make_train_step(dataclasses.replace(spec, apply=apply_keeping_first), cfg, optimizer,
                           reduction=opts["reduction"],
                           clip_value=opts["clip_value"],
                           elementwise_clamp=opts["elementwise_clamp"], stem_fn=stem_fn)
    state = {}
    gen = torch.Generator(device=dev)

    def forever():
        k = 0
        while True:
            yield k
            k += 1

    feed = device_prefetch(forever(), lambda k: (batches[k % len(batches)], k), dev)

    # set-up: the step's first three steps, through the window's call and feed
    leaves = tree_leaves(params)
    losses, first_norms = [], None
    for _ in range(FIRST_STEPS):
        batch, k = next(feed)
        gen.manual_seed(step_seed(ctx.seed, k))
        state, m = step(params, state, batch, gen)
        losses.append(float(m["loss"]))
        if first_norms is None:   # the gradient Adam took: its first moment / (1 - beta1)
            first_norms = [float(optimizer.state[p]["exp_avg"].norm() / 0.1)
                           if "exp_avg" in optimizer.state[p] else 0.0 for p in leaves]
    changes = [float((p.detach().cpu() - q).norm())
               for p, q in zip(leaves, ref_mac.tree_leaves(initial))]
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    sync()
    ctx.setup_done()

    steps = 0
    videos = 0.0
    least = 0.0
    with Window(ctx.traced, sync) as w:
        while True:
            with w.span("device_prefetch"):
                batch, k = next(feed)
            gen.manual_seed(step_seed(ctx.seed, k))
            with w.span("train step"):
                state, m = step(params, state, batch, gen)
            host = batches[k % len(batches)]
            for v, q in zip(host["v_len"].tolist(), host["q_len"].tolist()):
                least += counts.mac_train_least_s(cfg_d, v, q)
            steps += 1
            videos += B
            if time.perf_counter() - w.t0 >= ctx.seconds:
                break
        w.close()
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    ctx.note(f"{steps} steps ({videos:.0f} videos) over {w.seconds:.3f} s; losses of the first"
             f" {FIRST_STEPS} {losses}")
    ctx.rec["model_least_s"] = least
    del feed, step, optimizer, params, state, leaves, m, batch
    if ctx.traced:
        video = batches[0]["video"].to(dev).float() / 255.0
        ctx.rec["stem_ms"] = cuda_ms(lambda: stem_fn(video))
        del video
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    compared = check(ctx, cfg_d, initial, stem, batches, first["log_probs"], losses, first_norms,
                     changes)
    return {"metrics": {"train_videos_per_s": videos / w.seconds},
            "attempted": steps * B, "failed": 0,
            "correct": all(v <= lim for v, lim in compared.values()),
            "compared": compared, "memory_peak_bytes": memory_peak, "trace": w.trace}


def reference_numbers(ctx, cfg_d, initial, stem, batches, prec):
    dev = ctx.device
    on_dev = [{name: t.to(dev) for name, t in batches[k % len(batches)].items()}
              for k in range(FIRST_STEPS)]
    opts = ctx.cell["step"]
    params = inputs.clone_tree(initial, dev)
    return ref_mac.train_steps(
        params, on_dev, lambda v: ref_stem.video_features(stem, v, prec), cfg_d,
        [step_seed(ctx.seed, k) for k in range(FIRST_STEPS)], lr=opts["l_rate"],
        clamp=opts["elementwise_clamp"], clip=opts["clip_value"], prec=prec, device=dev)


def numbers(log_probs, losses, norms, changes, ref):
    """(step 1's log-probability gap, each step's loss gap, grad_gap,
    change_gap) of a run against the reference's (the same readings)."""
    r_log_probs, r_losses, r_norms, r_changes = ref
    med = statistics.median(r_norms)
    keep = [n >= 1e-3 * med for n in r_norms]
    loss_gaps = [gap(a, b, abs(b)) for a, b in zip(losses, r_losses)]
    return (float((log_probs - r_log_probs).abs().max()), *loss_gaps,
            leaf_gaps(norms, r_norms), leaf_gaps(changes, r_changes, keep))


def check(ctx, cfg_d, initial, stem, batches, log_probs, losses, first_norms, changes):
    init_leaves = ref_mac.tree_leaves(initial)

    def run_ref(prec):
        r_log_probs, r_losses, r_norms, r_final = reference_numbers(ctx, cfg_d, initial, stem,
                                                                    batches, prec)
        r_changes = [float((p.cpu() - q).norm()) for p, q in zip(r_final, init_leaves)]
        return r_log_probs.cpu(), r_losses, r_norms, r_changes

    ref = run_ref(REF)
    got = numbers(log_probs, losses, first_norms, changes, ref)
    limits = ctx.cell["limits"]
    names = ("logprob1_gap",) + tuple(f"loss{k + 1}_gap" for k in range(FIRST_STEPS)) + (
        "grad_gap", "change_gap")
    compared = {n: [v, limits[n]] for n, v in zip(names, got)}
    ctx.note(f"reference losses {ref[1]}")
    if ctx.control:
        ctx.rec["control"] = {}
        for control in ctx.cell["controls"]:
            low = run_ref(CONTROLS[control])
            ctx.rec["control"][control] = dict(zip(names, numbers(*low, ref)))
            ctx.note(f"control {control}: {ctx.rec['control'][control]}")
    return compared
