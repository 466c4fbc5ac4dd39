"""What the serving cells share: the pool of requests, the engine under test
built on the benchmark's weights, each dispatched batch's work in the
yardstick's counts, and the check of the served probabilities against the
plain reference."""

from __future__ import annotations

import time

import numpy as np
import torch

from vnqa_bench import counts, inputs
from vnqa_bench.reference import film_attn as ref_film
from vnqa_bench.reference import stem as ref_stem
from vnqa_bench.reference.ops import CONTROLS, REF
from vnqa_bench.trace import cuda_ms

Q_SLOTS = inputs.Q_SLOTS


class Pool:
    """``ctx.pool`` requests made from the seed: frames (bf16 features or
    uint8 video, in host memory), lengths and questions."""

    def __init__(self, ctx, video):
        n, cfg = ctx.pool, ctx.model_cfg()
        self.video = video
        self.v_len, self.q_len = inputs.lengths(n, ctx.seed, ctx.cell["mix"])
        self.tokens = inputs.questions(n, self.q_len, ctx.seed, cfg["vocab_size"])
        if video:
            self.frames = inputs.videos(n, ctx.seed, ctx.device)
        else:
            self.frames = inputs.features(n, ctx.seed, cfg["num_input_channels"], ctx.device)
        self.n = n

    def item(self, i):
        """One request as the engine takes it: (frames, v_len, tokens)."""
        v = int(self.v_len[i])
        frames = self.frames[i, :v]
        return (frames.numpy() if self.video else frames, v, self.tokens[i, :self.q_len[i]])

    def padded(self, indices, T, B, device):
        """The padded batch the engine builds of these requests (padding rows
        have v_len = q_len = 1 and zero frames and tokens)."""
        vis = torch.zeros((B, T, *self.frames.shape[2:]), dtype=self.frames.dtype)
        q = torch.zeros((B, Q_SLOTS), dtype=torch.int32)
        v_len = torch.ones(B, dtype=torch.int32)
        q_len = torch.ones(B, dtype=torch.int32)
        for r, i in enumerate(indices):
            v = min(int(self.v_len[i]), T)
            vis[r, :v] = self.frames[i, :v]
            q[r] = torch.from_numpy(self.tokens[i])
            v_len[r], q_len[r] = int(self.v_len[i]), int(self.q_len[i])
        batch = {"question": q, "q_len": q_len, "v_len": v_len,
                 ("video" if self.video else "v_features"): vis}
        return {k: t.to(device) for k, t in batch.items()}


def make_weights(ctx):
    """(params, state, stem or None) of the configuration, on the device."""
    cfg, dev = ctx.model_cfg(), ctx.device
    p_shapes, s_shapes = ref_film.shapes(cfg)
    params = inputs.make_weights(p_shapes, ctx.seed, 10, dev)
    state = inputs.make_weights(s_shapes, ctx.seed, 11, dev)
    stem = None
    if ctx.cell["input"] == "video":
        det_p, det_s = ref_stem.detector_shapes(cfg["num_input_channels"])
        stem = (inputs.make_weights(ref_stem.vgg_shapes(), ctx.seed, 12, dev),
                inputs.make_weights(det_p, ctx.seed, 13, dev),
                inputs.make_weights(det_s, ctx.seed, 14, dev))
    return params, state, stem


def build_engine(ctx, weights, frame_buckets):
    """The measured package's InferenceEngine on the benchmark's weights."""
    from videonavqa_tpu_torch.models.base import ModelConfig
    from videonavqa_tpu_torch.serve.engine import InferenceEngine

    params, state, stem = weights
    cfg = ModelConfig(**ctx.model_cfg())
    eng = InferenceEngine(cfg, seed=0, max_batch=ctx.cell["batch"], frame_buckets=frame_buckets,
                          device=ctx.device, from_video=stem is not None, stem=stem)
    # the engine takes weights from a checkpoint file or its own init; these
    # are the benchmark's, made on the card from the seed
    eng._load_weights(None, (params, state))
    return eng


def batch_least_s(cfg, B, T, q_lens, video):
    """{kernel: least seconds} of one padded batch's launches."""
    C, N = cfg["num_res_block_channels"], cfg["num_res_blocks"]
    rows = B * T * counts.POSITIONS
    out = {"film_reencode": counts.film_reencode(B, Q_SLOTS, cfg["hidden_size"], T, q_lens),
           "attn_tail": counts.attn_tail(B, T, cfg["at_hidden_size"], cfg["max_num_frames"]),
           # block 0 reads the BatchNorm's f32 output, the others the bf16 blocks'
           "int8_matmul": counts.int8_matmul(rows, C, C, 4)
           + (N - 1) * counts.int8_matmul(rows, C, C, 2)}
    if video:
        out["vgg_block1"] = counts.vgg_block1(B * T)
    return out


class Tally:
    """The yardstick's least times of the work a window completed."""

    def __init__(self, cfg, video):
        self.cfg, self.video = cfg, video
        self.kernel = {}
        self.model = 0.0
        self.videos = 0

    def add(self, pool, indices, B, T):
        q_lens = [int(pool.q_len[i]) for i in indices] + [1] * (B - len(indices))
        for k, s in batch_least_s(self.cfg, B, T, q_lens, self.video).items():
            self.kernel[k] = self.kernel.get(k, 0.0) + s
        for i in indices:
            self.model += counts.film_attn_least_s(self.cfg, int(pool.v_len[i]),
                                                   int(pool.q_len[i]), stem=self.video)
        self.videos += len(indices)

    def into(self, rec):
        rec.update(kernel_least_s=self.kernel, model_least_s=self.model)


def stem_ms(ctx, pool, weights, B):
    """Device ms of the measured package's stem_features on one batch of the
    cell's shapes (B videos x 35 frames), outside the window."""
    from videonavqa_tpu_torch.ops.video import normalize_video
    from videonavqa_tpu_torch.stem import stem_features

    batch = pool.padded(list(range(B)), inputs.MAX_FRAMES, B, ctx.device)
    video = normalize_video(batch["video"])
    return cuda_ms(lambda: stem_features(*weights[2], video, dtype=torch.bfloat16,
                                         use_kernel=True))


def logprob_gap(got, want, floor=1e-4):
    """The widest |log p - log p_ref| over the classes the reference gives at
    least ``floor``, over all rows."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    keep = want >= floor
    diff = np.abs(np.log(np.maximum(got, 1e-30)) - np.log(want))
    return float(diff[keep].max())


def feature_gap(got, want):
    """||got - want|| / ||want|| of the stem's features, in float64."""
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


class Checker:
    """The plain reference over the batches the program served: its own
    int8 scales from the calibration batch the program's set-up served,
    then each sampled batch's probabilities (and, from video, the stem's
    features the timed path computed)."""

    def __init__(self, ctx, pool, weights, calib_indices, calib_T):
        self.ctx, self.pool, self.weights = ctx, pool, weights
        self.cfg = ctx.model_cfg()
        self.B = ctx.cell["batch"]
        self.calib = (calib_indices, calib_T)

    def _batch(self, indices, T, prec):
        b = self.pool.padded(indices, T, self.B, self.ctx.device)
        if self.pool.video:
            b["v_features"] = ref_stem.video_features(self.weights[2], b.pop("video"), prec)
        return b

    def reference(self, batches, prec=REF):
        """[(probabilities [len(indices), K], the stem's features or None)] of
        each (indices, T) batch."""
        params, state, _ = self.weights
        with torch.no_grad():
            absmax = ref_film.calibrate(params, state, self._batch(*self.calib, prec), self.cfg,
                                        prec)
            out = []
            for indices, T in batches:
                batch = self._batch(indices, T, prec)
                logits = ref_film.forward(params, state, batch, absmax, self.cfg, prec)
                feats = batch["v_features"].cpu() if self.pool.video else None
                out.append((torch.softmax(logits, dim=-1)[:len(indices)].cpu().numpy(), feats))
                del logits, batch
        return out

    def numbers(self, served, got):
        """{name: value} of served [(indices, T, probs, features or None)]
        against the reference's ``got``."""
        out = {"logprob_gap": max(logprob_gap(s[2], g[0]) for s, g in zip(served, got))}
        feats = [(s[3], g[1]) for s, g in zip(served, got) if s[3] is not None]
        if feats:
            out["feature_gap"] = max(feature_gap(a.float(), b.float()) for a, b in feats)
        return out

    def compare(self, served):
        """served: [(indices, T, probs, features or None)] -> ({name: [value,
        limit]}, seconds)."""
        t0 = time.perf_counter()
        batches = [(s[0], s[1]) for s in served]
        want = self.reference(batches)
        limits = self.ctx.cell["limits"]
        compared = {k: [v, limits[k]] for k, v in self.numbers(served, want).items()}
        if self.ctx.control:
            self.ctx.rec["control"] = {}
            for control in self.ctx.cell["controls"]:
                low = self.reference(batches, CONTROLS[control])
                as_served = [(i, T, p, f) for (i, T), (p, f) in zip(batches, low)]
                self.ctx.rec["control"][control] = self.numbers(as_served, want)
                self.ctx.note(f"control {control}: {self.ctx.rec['control'][control]}")
        return compared, time.perf_counter() - t0


def sample(rng, n, k):
    return sorted(rng.choice(n, size=min(k, n), replace=False).tolist())
