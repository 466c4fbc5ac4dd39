"""Train/val/test split builder.

The reference assigns examples to splits by their house's membership in the
EmbodiedQA eqa_v1.json house splits
(scripts/stats_for_generated_questions.py:39-63). ``build_split`` accepts any
{'train': [house_ids], 'val': ..., 'test': ...} mapping; ``split_houses``
derives one deterministically by fraction when no external split exists
(synthetic datasets)."""

from __future__ import annotations

import json
import os


def split_houses(house_ids, *, train_frac=0.8, val_frac=0.1, seed=0):
    import random

    house_ids = sorted(house_ids)
    random.Random(seed).shuffle(house_ids)
    n = len(house_ids)
    n_train = max(1, int(n * train_frac))
    n_val = max(1, int(n * val_frac)) if n - n_train >= 2 else max(0, n - n_train - 1)
    return {"train": house_ids[:n_train],
            "val": house_ids[n_train:n_train + n_val],
            "test": house_ids[n_train + n_val:]}


def build_split(data_dir, house_splits, split_file=None):
    """{'train'/'val'/'test': [example_ids]} from per-house question JSONs."""
    membership = {h: part for part, houses in house_splits.items() for h in houses}
    split = {"train": [], "val": [], "test": []}
    for filename in sorted(os.listdir(data_dir)):
        if not filename.endswith(".json"):
            continue
        house_id = filename.split(".")[0]
        if house_id not in membership:
            raise KeyError(f"House id {house_id} not found in splits!")
        with open(os.path.join(data_dir, filename)) as f:
            data = json.load(f)
        for traj_id in data:
            split[membership[house_id]].append("%s_%04d" % (house_id, int(traj_id)))
    if split_file:
        with open(split_file, "w") as f:
            json.dump(split, f)
    return split
