"""Accuracy by question type and category over a test run's dumps (the port
of the JAX package's cli/results_analysis.py, with its category map).

It reads ``t_``, ``p_`` and ``q_<checkpoint name>.npy`` beside
``--checkpoint_path`` (the targets, predictions and question types that the
``*_test`` entry points write). The reference's map covers question types
0-27; type 28 ('Where is the <attr> <obj_type>?') falls in an explicit
``other`` bucket, so no question is dropped.

    python -m videonavqa_tpu_torch.cli.results_analysis --checkpoint_path e0_gp.npz
"""

from __future__ import annotations

import argparse
import os

import numpy as np

Q_CATEGORIES = {
    "equals_attr": [0, 1, 2, 3, 4, 5, 13],
    "count": [8, 9, 10, 11],
    "compare_count": [6, 7],
    "compare_size": [12, 14],
    "exist": [15, 16, 17, 18, 19, 20],
    "query_color": [21, 22],
    "query_obj": [23, 24],
    "query_room": [25, 26, 27],
    "other": [28],
}


def analyse(y_target, y_pred, q_ids, q_category="all"):
    """{category: (hits, total, {q_id: (hits, total)})}."""
    out = {}
    for cat, ids in Q_CATEGORIES.items():
        if q_category != "all" and cat != q_category:
            continue
        cat_hits = cat_total = 0
        per_id = {}
        for q_id in ids:
            idx = np.where(q_ids == q_id)[0]
            if idx.size == 0:
                continue
            hits = int((y_pred[idx] == y_target[idx]).sum())
            per_id[q_id] = (hits, idx.size)
            cat_hits += hits
            cat_total += idx.size
        out[cat] = (cat_hits, cat_total, per_id)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint_path", type=str, required=True)
    parser.add_argument("--q_category", type=str, default="all",
                        choices=sorted(Q_CATEGORIES) + ["all"])
    args = parser.parse_args(argv)

    d, b = os.path.split(args.checkpoint_path)
    yt, yp, q_ids = (np.load(os.path.join(d, prefix + b + ".npy")) for prefix in ("t_", "p_", "q_"))
    for cat, (hits, total, per_id) in analyse(yt, yp, q_ids, args.q_category).items():
        print(">>> Stats for %s:" % cat)
        for q_id, (h, n) in per_id.items():
            print("Accuracy for question type %d: %.4f (%d/%d)" % (q_id, 100.0 * h / n, h, n))
        if total:
            print("Accuracy for question category %s: %.4f (%d/%d)"
                  % (cat, 100.0 * hits / total, hits, total))


if __name__ == "__main__":
    main()
