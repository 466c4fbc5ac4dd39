"""Inputs and weights made from ``--seed``.

Every seed gets the same multiset of sizes (frame counts, question lengths)
in another order, so the work of a run does not depend on its seed, only the
values do: the sizes are the quantile midpoints of the cell's distributions,
permuted by the seed. Features, pixels, token ids and weights are drawn on
the device from a ``torch.Generator`` seeded from ``--seed``, in a few large
calls, and the input pools are then held in host memory.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MAX_FRAMES = 35
DROP_EVERY = 4
Q_SLOTS = 56
H, W = 160, 208


def rng_for(seed, stream):
    """A numpy generator for one use of the seed (any non-negative int)."""
    return np.random.default_rng([int(seed) % (1 << 63), stream])


def torch_gen(seed, stream, device):
    return torch.Generator(device=device).manual_seed((int(seed) * 1000003 + stream) % (1 << 63))


def quantiles_uniform_int(n, lo, hi):
    """The n quantile midpoints of the uniform distribution over lo..hi."""
    q = (np.arange(n) + 0.5) / n
    return lo + np.floor(q * (hi - lo + 1)).astype(np.int64)


def quantiles_histogram(n, hist):
    """The n quantile midpoints of a histogram {value (a string, as JSON keys
    are): count}."""
    values = np.array(sorted(int(k) for k in hist))
    counts = np.array([hist[str(v)] for v in values], float)
    cdf = np.cumsum(counts) / counts.sum()
    q = (np.arange(n) + 0.5) / n
    return values[np.searchsorted(cdf, q, side="left")]


def frames_after_pick(raw):
    """Frames kept by the loaders' 1-of-4 pick of a raw video: one per started
    4-frame bucket, at most 35."""
    return np.minimum(-(-np.minimum(raw, DROP_EVERY * MAX_FRAMES) // DROP_EVERY), MAX_FRAMES)


def lengths(n, seed, traffic):
    """(v_len [n], q_len [n]) of a pool: the same sizes for every seed."""
    lo, hi = traffic["raw_frames"]
    v = frames_after_pick(quantiles_uniform_int(n, lo, hi))
    q = quantiles_histogram(n, traffic["question_length_histogram"])
    rng = rng_for(seed, 1)
    return v[rng.permutation(n)], q[rng.permutation(n)]


def questions(n, q_len, seed, vocab):
    """Token ids [n, 56] int32 drawn from 1..vocab-1, zero past each length."""
    tok = rng_for(seed, 2).integers(1, vocab, size=(n, Q_SLOTS)).astype(np.int32)
    tok[np.arange(Q_SLOTS)[None, :] >= q_len[:, None]] = 0
    return tok


def features(n, seed, channels, device, chunk=32):
    """bf16 stem features [n, 35, 10, 13, C] (a ReLU's output: half zeros),
    made on the device and returned in host memory."""
    gen = torch_gen(seed, 3, device)
    out = torch.empty((n, MAX_FRAMES, 10, 13, channels), dtype=torch.bfloat16)
    for i in range(0, n, chunk):
        m = min(chunk, n - i)
        x = torch.randn((m, MAX_FRAMES, 10, 13, channels), generator=gen, device=device)
        out[i:i + m] = torch.relu(x).to(torch.bfloat16).cpu()
    return out


def videos(n, seed, device, chunk=32):
    """Smooth uint8 frames [n, 35, 160, 208, 3]: a 10 x 13 grid of random
    colours drifting frame to frame (0.9 of the last plus 0.1 of a fresh draw),
    each cell blown up to 16 x 16 pixels, made on the device and returned in
    host memory."""
    gen = torch_gen(seed, 4, device)
    out = torch.empty((n, MAX_FRAMES, H, W, 3), dtype=torch.uint8)
    for i in range(0, n, chunk):
        m = min(chunk, n - i)
        draws = torch.randint(0, 256, (MAX_FRAMES + 1, m, 10, 13, 3), generator=gen,
                              device=device).float()
        small = draws[0]
        frames = []
        for t in range(MAX_FRAMES):
            small = 0.9 * small + 0.1 * draws[t + 1]
            frames.append(small)
        grid = torch.stack(frames, dim=1)                      # [m, 35, 10, 13, 3]
        big = grid.repeat_interleave(16, dim=2).repeat_interleave(16, dim=3)
        out[i:i + m] = big.clamp_(0, 255).to(torch.uint8).cpu()
    return out


# --- weights -------------------------------------------------------------------

def _is_shape(x):
    return isinstance(x, tuple) and all(isinstance(d, int) for d in x)


def _leaves(tree, prefix=""):
    if _is_shape(tree):
        return [(prefix[:-1], tree)]
    if isinstance(tree, dict):
        return [it for k, v in tree.items() for it in _leaves(v, f"{prefix}{k}/")]
    return [it for i, v in enumerate(tree) for it in _leaves(v, f"{prefix}{i}/")]


def _fill(tree, it):
    if _is_shape(tree):
        return next(it)
    if isinstance(tree, dict):
        return {k: _fill(v, it) for k, v in tree.items()}
    return [_fill(v, it) for v in tree]


def _bound(path, shape):
    """Half-width of a leaf's uniform draw and its centre: Xavier's bound for
    weights, small values for biases, around 1 for norm scales, variances and
    the LSTM forget gate's bias block."""
    name = path.rsplit("/", 1)[-1]
    if name == "var" or (name == "weight" and len(shape) == 1):
        return 0.25, 1.0
    if len(shape) == 1 or name in ("mem_0", "control_0"):
        return 0.05, 0.0
    fan_in = shape[1] * math.prod(shape[2:])
    fan_out = shape[0] * math.prod(shape[2:])
    return math.sqrt(6.0 / (fan_in + fan_out)), 0.0


def make_weights(shapes, seed, stream, device):
    """A tree of f32 tensors of ``shapes`` on ``device``: one uniform draw for
    all leaves, each leaf scaled to its bound (``_bound``); an LSTM's b_hh
    gets +1 on its forget-gate block."""
    leaves = _leaves(shapes)
    sizes = [math.prod(s) for _, s in leaves]
    flat = torch.rand(sum(sizes), generator=torch_gen(seed, stream, device), device=device)
    flat.mul_(2.0).sub_(1.0)
    out = []
    for (path, shape), part in zip(leaves, flat.split(sizes)):
        half, centre = _bound(path, shape)
        t = part.view(shape).mul(half).add_(centre)
        if path.endswith("b_hh"):
            h = shape[0] // 4
            t[h:2 * h] += 1.0
        out.append(t)
    return _fill(shapes, iter(out))


def clone_tree(tree, device=None):
    if isinstance(tree, dict):
        return {k: clone_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone_tree(v, device) for v in tree]
    return tree.detach().to(device, copy=True) if device is not None else tree.detach().clone()
