"""Data-driven frame buckets for length-bucketed trimming (a copy of the JAX
package's data/buckets.py).

With length-sorted batches and each batch's frame axis trimmed to the
smallest bucket >= its longest video (``BatchLoader.frame_buckets``), the
frames computed per example are about the bucket its own length lands in.
``optimal_frame_buckets`` picks the K bucket edges that minimize the total
computed frames for a dataset's own lengths, by an exact DP over the m <= 35
distinct lengths (O(m^2 k)).
"""

from __future__ import annotations

import numpy as np

#: the size of the default grid (utils/constants.py FRAME_BUCKETS)
DEFAULT_NUM_BUCKETS = 8


def bucket_frame_cost(lengths, buckets) -> int:
    """Total frames computed when each example is padded up to the smallest
    bucket >= its length. Lengths above every bucket count as themselves (the
    loaders then keep the full container)."""
    lengths = np.asarray(lengths)
    buckets = np.asarray(sorted(buckets))
    idx = np.searchsorted(buckets, lengths, side="left")
    padded = np.where(idx < len(buckets),
                      buckets[np.minimum(idx, len(buckets) - 1)], lengths)
    return int(padded.sum())


def optimal_frame_buckets(lengths, k: int = DEFAULT_NUM_BUCKETS):
    """The least-cost bucket set for ``lengths`` with at most ``k`` buckets,
    as an ascending tuple. Edges are drawn from the observed lengths and the
    largest length is always one, so every example maps to a bucket; at equal
    cost the smallest set wins."""
    lengths = np.asarray(lengths)
    if lengths.size == 0:
        raise ValueError("optimal_frame_buckets needs at least one length")
    if k < 1:
        raise ValueError(f"need k >= 1 buckets, got {k}")
    vals, counts = np.unique(lengths, return_counts=True)
    m = len(vals)
    if m <= k:
        return tuple(int(v) for v in vals)

    prefix = np.concatenate([[0], np.cumsum(counts)])  # prefix[j] = count of vals[:j]
    # f[r][j] = min cost covering vals[:j] with r buckets, vals[j-1] an edge
    f = np.full((k + 1, m + 1), float("inf"))
    back = np.zeros((k + 1, m + 1), dtype=np.int64)
    f[0][0] = 0.0
    for r in range(1, k + 1):
        for j in range(r, m + 1):
            # bucket r covers vals[i:j], padded up to vals[j-1]
            cand = f[r - 1][:j] + float(vals[j - 1]) * (prefix[j] - prefix[:j])
            i = int(np.argmin(cand))
            f[r][j], back[r][j] = cand[i], i
    r = int(np.argmin(f[:, m]))
    edges = []
    j = m
    while r > 0:
        edges.append(int(vals[j - 1]))
        j = int(back[r][j])
        r -= 1
    return tuple(sorted(edges))


def resolve_frame_buckets(spec, lengths_fn, default, k: int = DEFAULT_NUM_BUCKETS):
    """A loader's ``frame_buckets`` argument as a bucket tuple: ``True`` ->
    ``default``; ``"auto"`` -> ``optimal_frame_buckets(lengths_fn())`` over the
    subsampled lengths; another truthy value -> its buckets as given; a falsy
    one -> ``None`` (no trimming)."""
    if spec is True:
        return default
    if spec == "auto":
        return optimal_frame_buckets(lengths_fn(), k=k)
    return tuple(spec) if spec else None
