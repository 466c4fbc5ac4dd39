"""A synthetic dataset on disk (a copy of the JAX package's data/synthetic.py).

It has the layout of a generated VideoNavQA dataset: ``videos/<id>.mp4`` or
``.npy``, ``encoded_questions/<id>.npy``, ``labels.json``, ``q_ids.json`` and
``split.json``, so the loaders and the harness run end to end without a
renderer. From the same seed it writes the same bytes as the JAX package's
generator. mp4 needs OpenCV, imported only for that format.
"""

from __future__ import annotations

import json
import os

import numpy as np

from videonavqa_tpu_torch.utils import constants as C

NUM_Q_TEMPLATES = 29


def generate_synthetic_dataset(out_dir, *, num_houses=3, trajs_per_house=6,
                               seed=0, video_format="mp4", min_frames=8,
                               max_frames=120):
    """Writes the dataset under ``out_dir``; returns the sorted example ids.
    Houses go to train, then one to val and one to test, in turn."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(out_dir, "videos"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "encoded_questions"), exist_ok=True)

    labels, q_ids, split = {}, {}, {"train": [], "val": [], "test": []}
    split_names = ["train"] * max(1, num_houses - 2) + ["val", "test"][: max(0, num_houses - 1)]

    for h in range(num_houses):
        house = f"house{h:04d}"
        part = split_names[h % len(split_names)]
        for t in range(trajs_per_house):
            ex_id = f"{house}_{t:04d}"
            T = int(rng.randint(min_frames, max_frames + 1))
            video = _smooth_video(rng, T)
            base = os.path.join(out_dir, "videos", ex_id)
            if video_format == "mp4":
                _write_mp4(base + ".mp4", video)
            else:
                np.save(base + ".npy", video)

            q_len = int(rng.randint(3, 13))
            tokens = rng.randint(1, C.VOCAB_SIZE, size=q_len).astype(np.int64)
            np.save(os.path.join(out_dir, "encoded_questions", ex_id + ".npy"), tokens)

            labels[ex_id] = int(rng.randint(0, C.NUM_CLASSES))
            q_ids[ex_id] = int(rng.randint(0, NUM_Q_TEMPLATES))
            split[part].append(ex_id)

    for name, obj in [("labels.json", labels), ("q_ids.json", q_ids), ("split.json", split)]:
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump(obj, f)
    return sorted(labels)


def _smooth_video(rng, T):
    """Temporally correlated random frames [T, 160, 208, 3] uint8."""
    small = rng.randint(0, 256, size=(10, 13, 3)).astype(np.float32)
    frames = np.empty((T, C.VID_HEIGHT, C.VID_WIDTH, 3), dtype=np.uint8)
    for t in range(T):
        small = 0.9 * small + 0.1 * rng.randint(0, 256, size=small.shape)
        up = np.kron(small, np.ones((16, 16, 1), dtype=np.float32))
        frames[t] = np.clip(up, 0, 255).astype(np.uint8)
    return frames


def _write_mp4(path, video):
    """mp4v at 10 fps."""
    import cv2

    writer = cv2.VideoWriter(
        path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (C.VID_WIDTH, C.VID_HEIGHT))
    for frame in video:
        writer.write(frame)
    writer.release()
