#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its CUDA kernels to account.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU or to a
kernel's plain version):

1. build   — nvcc compiles every kernel in videonavqa_tpu_torch/csrc/ for
             sm_90a, one process per source, all at once;
2. card    — prints the card's name and power limit (nvidia-smi);
3. kernels — each kernel against its plain PyTorch version on the card, at
             the full-width shapes of the serving path, with the tolerances
             stated below; times the kernel, the plain version and, where one
             PyTorch call computes part of the same work, that call
             (``library_ms``, a yardstick the port never calls);
4. serve   — InferenceEngine at the film_attn_pt eval.sh preset (5 FiLM
             blocks x 1024 channels, hidden/attention/embed 128, 512 input
             channels, bf16, 35 frames, 56 tokens, 134 words, 70 classes)
             with seeded random weights and seeded bf16 features, the static
             int8 trunk and the kernels on. It calibrates on its first
             micro-batch, then serves batch 32 in two frame buckets (above
             the fused-1x1 row gate) and batch 1 at 35 frames (under it),
             with every launch counter set to 0 just before and read just
             after; then holds the kernel path against the plain path on the
             same calibrated state and times ms/video.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it holds the per-kernel JSON record.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import torch

from videonavqa_tpu_torch.kernels import _build
from videonavqa_tpu_torch.kernels import attn_tail as attn_mod
from videonavqa_tpu_torch.kernels import film_reencode as reenc_mod
from videonavqa_tpu_torch.kernels import int8_matmul as int8_mod
from videonavqa_tpu_torch.models import ModelConfig
from videonavqa_tpu_torch.ops import initializers as init
from videonavqa_tpu_torch.ops.masking import attn_frame_mask, length_mask
from videonavqa_tpu_torch.ops.quant import act_scale, quantize_act, quantize_weight_channelwise
from videonavqa_tpu_torch.serve.engine import InferenceEngine
from videonavqa_tpu_torch.train.step import forward

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12        # outside the tensor cores
INT8_OPS = 1979e12       # tensor cores

# Tolerances.
RECURRENCE_ATOL = 1e-5   # f32 recurrences; sums taken in another order
YQ_MAX_STEP = 1          # int8 requant: at most one step apart ...
YQ_MAX_FRACTION = 1e-4   # ... on at most this share of elements
PROB_ATOL = 2e-2         # serving, kernel path vs plain path, probabilities
ARGMAX_MARGIN = 1e-2     # argmax must agree where the top-2 logit margin is wider

REPO_SOURCE = {
    "film_reencode": ("videonavqa_tpu_torch/csrc/film_reencode.cu",
                      "videonavqa_tpu/kernels/film_reencode_pallas.py:65"),
    "attn_tail": ("videonavqa_tpu_torch/csrc/attn_tail.cu",
                  "videonavqa_tpu/kernels/attn_tail_pallas.py:60"),
    "int8_matmul_fused": ("videonavqa_tpu_torch/csrc/int8_matmul.cu",
                          "videonavqa_tpu/kernels/int8_matmul_pallas.py:58"),
}


def log(msg):
    print(msg, flush=True)


def time_ms(fn, iters, warmup=2):
    """Mean device time of ``fn()`` over ``iters`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_device_ms(fn, kernel, iters=10):
    """Device time of one launch of the CUDA kernel named ``kernel`` inside
    ``fn()``, read from torch.profiler (CUPTI); None where the profiler sees
    no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key]
    total_us = sum(e.self_device_time_total for e in hits)
    count = sum(e.count for e in hits)
    return total_us / count / 1e3 if count else None


def device_breakdown(fn, top=8):
    """(device busy ms, wall ms, [(kernel, ms)] by device time) of one ``fn()``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return sum(ms for _, ms in rows), wall, rows[:top]


def timings(kernel_fn, plain_fn, kernel, iters, plain_iters):
    """ms: the kernel's own device time per launch (profiler; the wrapper's
    event-timed call where the profiler sees no kernel); wrapper_ms: one
    wrapper call, glue included, by CUDA events; plain_ms: the plain version."""
    wrapper = time_ms(kernel_fn, iters)
    dev = kernel_device_ms(kernel_fn, kernel)
    return dict(ms=dev if dev is not None else wrapper, wrapper_ms=wrapper,
                plain_ms=time_ms(plain_fn, plain_iters, warmup=1))


def bound_ms(nbytes, ops, peak):
    """(least time in ms, which bound) for ``nbytes`` moved and ``ops`` done."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_film_reencode(dev):
    """B in {1, 32}, Tq 56, H 128, F 35, ragged q_len including 1 and 56."""
    gen = torch.Generator().manual_seed(1)
    H, E, Tq, F = 128, 128, 56, 35
    cell = init.reference_lstm(gen, E, H)
    rows = {}
    for B in (1, 32):
        lens = torch.randint(1, Tq + 1, (B,), generator=gen, dtype=torch.int32)
        lens[0] = Tq if B == 1 else 1
        if B > 1:
            lens[1] = Tq
        emb = torch.randn((B, Tq, E), generator=gen)
        xw = (emb @ cell["w_ih"].t() + cell["b_ih"]).transpose(0, 1).contiguous()
        args = [t.to(dev) for t in (xw, cell["w_hh"], cell["b_hh"], lens)] + [F]
        got = reenc_mod.film_reencode(*args)
        want = reenc_mod.film_reencode_plain(*args)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        log(f"  film_reencode B={B}: max_abs_err {err:.3e} (atol {RECURRENCE_ATOL})")
        if not err <= RECURRENCE_ATOL:
            raise AssertionError(f"film_reencode B={B} disagrees: {err}")
        steps = F * int(lens.sum())
        nbytes = xw.numel() * 4 + cell["w_hh"].numel() * 4 + 4 * H * 4 + B * 4 + F * B * H * 4
        ops = steps * (2 * 4 * H * H + 12 * H)
        b_ms, b_by = bound_ms(nbytes, ops, F32_FLOPS)
        rows[B] = dict(
            max_abs_err=err, bound_ms=b_ms, bound_by=b_by, library_ms=None,
            **timings(lambda: reenc_mod.film_reencode(*args),
                      lambda: reenc_mod.film_reencode_plain(*args), "film_reencode_kernel",
                      10, 2))
        log(f"  film_reencode B={B}: {rows[B]['ms']:.4f} ms (wrapper {rows[B]['wrapper_ms']:.4f}),"
            f" plain {rows[B]['plain_ms']:.3f} ms,"
            f" bound {b_ms:.5f} ms by {b_by}; the serial chain is {F} x max q_len ="
            f" {F * int(lens.max())} dependent steps")
    return rows


def check_attn_tail(dev):
    """B in {1, 32}, T in {35, 20} (n_phantom 0 and 15), A 128."""
    gen = torch.Generator().manual_seed(2)
    A, S = 128, 35
    params = {"fc_hidden_attn": init.reference_linear(gen, 1, A),
              "lstm_attn": init.reference_lstm(gen, A, A)}
    params = {k: {n: t.to(dev) for n, t in v.items()} for k, v in params.items()}
    rows = {}
    for B in (1, 32):
        for T in (35, 20):
            v_lens = torch.randint(1, T + 1, (B,), generator=gen, dtype=torch.int32)
            v_lens[0] = T
            v_lens = v_lens.to(dev)
            fmask = length_mask(v_lens, T)
            feats = (torch.randn((B, T, A), generator=gen).to(dev)) * fmask[..., None]
            scores = torch.where(fmask, torch.randn((B, T), generator=gen).to(dev), 0.0)
            mask = attn_frame_mask(v_lens, T)
            args = (params, feats, scores, mask, S, float(S - T))
            got = attn_mod.attn_tail(*args)
            want = attn_mod.attn_tail_plain(*args)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            log(f"  attn_tail B={B} T={T}: max_abs_err {err:.3e} (atol {RECURRENCE_ATOL})")
            if not err <= RECURRENCE_ATOL:
                raise AssertionError(f"attn_tail B={B} T={T} disagrees: {err}")
            nbytes = 4 * (B * T * A + 2 * B * T + A + 1 + 2 * 4 * A * A + 4 * A + B * S * A)
            ops = B * S * (2 * A + 6 * T + 2 * T * A + 2 * 2 * 4 * A * A + 12 * A)
            b_ms, b_by = bound_ms(nbytes, ops, F32_FLOPS)
            rows[(B, T)] = dict(
                max_abs_err=err, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                **timings(lambda: attn_mod.attn_tail(*args),
                          lambda: attn_mod.attn_tail_plain(*args), "attn_tail_kernel", 20, 3))
            r = rows[(B, T)]
            log(f"  attn_tail B={B} T={T}: {r['ms']:.4f} ms (wrapper {r['wrapper_ms']:.4f}),"
                f" plain {r['plain_ms']:.3f} ms,"
                f" bound {b_ms:.5f} ms by {b_by}; the serial chain is {S} dependent steps")
    return rows


def _bf16_ulp(v):
    """One bf16 unit in the last place at |v| (8 significant bits)."""
    e = torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def check_int8_matmul(dev):
    """rows 4,550 (batch 1 x 35 frames x 10 x 13) and an odd count, 1024 -> 1024,
    x bf16 and f32, with and without ReLU and requant.

    The integer parts (quantize, int8 product) are exact; y must lie within
    one bf16 ulp of the plain version's; yq within one int8 step, on at most
    a tiny share of elements (f32 round-off at a rounding boundary)."""
    gen = torch.Generator().manual_seed(3)
    C = 1024
    w = init.reference_conv2d(gen, 1, 1, C, C)["weight"]
    wq, w_scale = quantize_weight_channelwise(w)
    wq2 = wq[:, :, 0, 0].contiguous().to(dev)
    w_scale = w_scale.to(dev)
    bias = (0.1 * torch.randn(C, generator=gen)).to(dev)
    rows = {}
    for M in (4550, 1337):
        for x_dtype, relu, requant in ((torch.bfloat16, True, True), (torch.float32, True, True),
                                       (torch.bfloat16, False, False)):
            x = torch.relu(torch.randn((M, C), generator=gen)).to(dev).to(x_dtype)
            sx = act_scale(1.25 * x.float().abs().amax())
            comb = (sx * w_scale).contiguous()
            y_ref, _ = int8_mod.int8_matmul_plain(x, wq2, comb, bias, sx, None, relu=relu,
                                                  out_dtype=torch.float32)
            nx = act_scale(1.25 * y_ref.abs().amax()) if requant else None
            args = (x, wq2, comb, bias, sx, nx)
            y, yq = int8_mod.int8_matmul_2d(*args, relu=relu, out_dtype=torch.bfloat16)
            y_p, yq_p = int8_mod.int8_matmul_plain(*args, relu=relu, out_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            y32, yp32 = y.float(), y_p.float()
            err = (y32 - yp32).abs().max().item()
            off_ulp = int(((y32 - yp32).abs() > _bf16_ulp(yp32)).sum())
            tag = f"M={M} x={str(x_dtype)[6:]} relu={relu} requant={requant}"
            log(f"  int8_matmul_fused {tag}: y max_abs_err {err:.3e},"
                f" elements beyond 1 bf16 ulp: {off_ulp}")
            if off_ulp:
                raise AssertionError(f"int8_matmul_fused {tag}: y beyond 1 bf16 ulp")
            if requant:
                step = (yq.int() - yq_p.int()).abs()
                frac = float((step > 0).float().mean())
                log(f"  int8_matmul_fused {tag}: yq max step {int(step.max())},"
                    f" share differing {frac:.2e}")
                if int(step.max()) > YQ_MAX_STEP or frac > YQ_MAX_FRACTION:
                    raise AssertionError(f"int8_matmul_fused {tag}: yq disagrees")
            if M == 4550 and relu and requant and x_dtype == torch.bfloat16:
                nbytes = M * C * 2 + C * C + 2 * C * 4 + 8 + M * C * 2 + M * C
                b_ms, b_by = bound_ms(nbytes, 2 * M * C * C, INT8_OPS)
                xq = quantize_act(x, sx)
                wt = wq2.t()
                rows["main"] = dict(
                    bound_ms=b_ms, bound_by=b_by,
                    library_ms=time_ms(lambda: torch._int_mm(xq, wt), 200),
                    **timings(lambda: int8_mod.int8_matmul_2d(*args, relu=True),
                              lambda: int8_mod.int8_matmul_plain(
                                  *args, relu=True, out_dtype=torch.bfloat16),
                              "int8_matmul_kernel", 200, 50))
                r = rows["main"]
                log(f"  int8_matmul_fused {tag}: {r['ms']:.4f} ms (wrapper {r['wrapper_ms']:.4f}),"
                    f" plain {r['plain_ms']:.4f} ms,"
                    f" torch._int_mm alone {r['library_ms']:.4f} ms, bound {b_ms:.5f} ms by {b_by}")
            rows.setdefault("errs", []).append(err)
    return rows


def serve(dev):
    cfg = ModelConfig(model="film_attn_pt", num_res_blocks=5, num_res_block_channels=1024,
                      hidden_size=128, at_hidden_size=128, embed_size=128,
                      num_input_channels=512, compute_dtype="bfloat16", max_num_frames=35,
                      max_q_len=56, vocab_size=134, num_classes=70,
                      use_pallas_kernels=True, use_int8_trunk=True)
    t0 = time.perf_counter()
    eng32 = InferenceEngine(cfg, seed=0, max_batch=32, device=dev)
    eng1 = InferenceEngine(cfg, seed=0, max_batch=1, device=dev)
    log(f"  weights: 2 engines from seed 0 in {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device=dev).manual_seed(4)
    cpu_gen = torch.Generator().manual_seed(5)
    n_items = 32 * 3 + 1
    feats = torch.relu(torch.randn((n_items, 35, 10, 13, 512), generator=gen, device=dev)
                       ).to(torch.bfloat16)

    def items(lo, hi, v_max):
        out = []
        for i in range(lo, hi):
            v = int(torch.randint(1, v_max + 1, (1,), generator=cpu_gen))
            q = int(torch.randint(1, 57, (1,), generator=cpu_gen))
            out.append((feats[i], v, torch.randint(1, 134, (q,), generator=cpu_gen).tolist()))
        return out

    cal = items(0, 32, 35)
    b20 = items(32, 64, 20)
    b35 = items(64, 96, 35)
    b35[0] = (b35[0][0], 35, b35[0][2])
    one = [(feats[96], 35, items(96, 97, 35)[0][2])]

    t0 = time.perf_counter()
    eng32.run_batch(cal)   # first micro-batch: the f32 calibration pass
    eng1.run_batch(one)
    torch.cuda.synchronize()
    log(f"  int8 calibration on each engine's first micro-batch: {time.perf_counter() - t0:.2f} s")
    if eng32.needs_int8_calibration or eng1.needs_int8_calibration:
        raise AssertionError("the engines did not calibrate")
    for eng, its in ((eng32, b20), (eng32, b35), (eng1, one)):   # warm-up
        eng.run_batch(its)

    for mod in (reenc_mod, attn_mod, int8_mod):
        mod.launches = 0
    outs = [eng32.run_batch(b20), eng32.run_batch(b35), eng1.run_batch(one)]
    torch.cuda.synchronize()
    launches = {"film_reencode": reenc_mod.launches, "attn_tail": attn_mod.launches,
                "int8_matmul_fused": int8_mod.launches}
    log(f"  launches on the main path (batch 32 at buckets 20 and 35, batch 1 at 35): {launches}")
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"{name} was not launched on the main path")
    for probs, its in zip(outs, (b20, b35, one)):
        if probs.shape != (len(its), 70):
            raise AssertionError(f"probabilities of shape {probs.shape}")
        row_sums = torch.from_numpy(probs).sum(dim=1)
        if not (torch.isfinite(torch.from_numpy(probs)).all()
                and float((row_sums - 1.0).abs().max()) < 1e-3):
            raise AssertionError("probabilities are not finite or do not sum to 1")

    plain_cfg = dataclasses.replace(cfg, use_pallas_kernels=False)
    worst = 0.0
    for eng, its in ((eng32, b20), (eng32, b35), (eng1, one)):
        batch = eng.make_batch(its)
        with torch.inference_mode():
            lk, _ = forward(eng.spec, cfg, eng.params, eng.state, batch)
            lp, _ = forward(eng.spec, plain_cfg, eng.params, eng.state, batch)
        n = len(its)
        lk, lp = lk[:n].float(), lp[:n].float()
        pdiff = (torch.softmax(lk, -1) - torch.softmax(lp, -1)).abs().max().item()
        top2 = lp.topk(2, dim=-1).values
        wide = (top2[:, 0] - top2[:, 1]) > ARGMAX_MARGIN
        agree = (lk.argmax(-1) == lp.argmax(-1))
        log(f"  kernel vs plain path, batch {eng.B} T{eng.bucket_for(max(v for _, v, _ in its))}:"
            f" max |dprob| {pdiff:.3e} (bound {PROB_ATOL}), argmax agree"
            f" {int(agree.sum())}/{n} ({int(wide.sum())} rows with margin > {ARGMAX_MARGIN})")
        if pdiff > PROB_ATOL or not bool(agree[wide].all()):
            raise AssertionError("the kernel path disagrees with the plain path")
        worst = max(worst, pdiff)

    def per_video(eng, its, iters, run_cfg):
        saved, eng.cfg = eng.cfg, run_cfg
        try:
            eng.run_batch(its)
            t0 = time.perf_counter()
            for _ in range(iters):
                eng.run_batch(its)
            return (time.perf_counter() - t0) / iters / len(its) * 1e3
        finally:
            eng.cfg = saved

    ms = {}
    for label, eng, its, iters in (("batch 32 T35", eng32, b35, 5), ("batch 1 T35", eng1, one, 10)):
        ms[label] = (per_video(eng, its, iters, cfg), per_video(eng, its, iters, plain_cfg))
        busy, wall, top = device_breakdown(lambda: eng.run_batch(its))
        log(f"  {label}: kernel path {ms[label][0]:.4f} ms/video, plain path"
            f" {ms[label][1]:.4f} ms/video; one batch: device busy {busy:.3f} ms of"
            f" {wall:.3f} ms wall (idle share {max(0.0, 1 - busy / wall):.3f})")
        for name, t in top:
            log(f"    {t:9.4f} ms  {name[:110]}")
    return launches, ms, worst


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("phase build")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"  built {', '.join(_build.SOURCES)} in {time.perf_counter() - t0:.1f} s")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    log("phase card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    log(card)

    log("phase kernels")
    reenc = check_film_reencode(dev)
    attn = check_attn_tail(dev)
    int8 = check_int8_matmul(dev)

    log("phase serve")
    launches, ms, worst = serve(dev)
    log(f"  serving on {card}, kernel path (plain path) ms/video: "
        + ", ".join(f"{k} {a:.4f} ({b:.4f})" for k, (a, b) in ms.items())
        + f"; worst kernel-vs-plain |dprob| {worst:.3e}")

    def entry(name, row, err):
        src, repl = REPO_SOURCE[name]
        return {"name": name, "route": "cuda", "source": src, "replaces": repl,
                "launches": launches[name], "max_abs_err": err, "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"]}

    kernels = [
        entry("film_reencode", reenc[32], max(r["max_abs_err"] for r in reenc.values())),
        entry("attn_tail", attn[(32, 35)], max(r["max_abs_err"] for r in attn.values())),
        entry("int8_matmul_fused", int8["main"], max(int8["errs"])),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
