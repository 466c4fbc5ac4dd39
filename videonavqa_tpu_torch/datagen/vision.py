"""Semantic/depth frame processing for trajectory observation.

Vectorized rebuild of the reference's per-frame analysis
(scripts/trajectory_gen.py:614-699): semantic RGB -> packed int labels,
connected components per object class, one approximate depth sample per
component (depth/255*20 meters).
"""

from __future__ import annotations

import csv

import numpy as np
from scipy import ndimage

from videonavqa_tpu_torch.datagen.ontology import QUERY_OBJECTS

DEPTH_SCALE = 20.0 / 255.0  # scripts/trajectory_gen.py:624


def rgb_to_int_image(img) -> np.ndarray:
    """(r, g, b) -> 256^2*r + 256*g + b (scripts/trajectory_gen.py:696-699)."""
    img = np.asarray(img, dtype=np.int32)
    return (img[:, :, 0] << 16) | (img[:, :, 1] << 8) | img[:, :, 2]


def load_semantic_colormap(path) -> dict:
    """colormap_coarse.csv -> {(r, g, b): class name}
    (scripts/trajectory_gen.py:681-689)."""
    with open(path, newline="") as f:
        return {(int(row["r"]), int(row["g"]), int(row["b"])): row["name"]
                for row in csv.DictReader(f)}


def objects_in_frame(semantic_img, rgb_to_obj, depth_img):
    """Per-class component counts and approximate depths for one frame.

    Returns {class_name: {'count': n, 'depths': [meters, ...]}} for queryable
    classes. Each connected component's depth is sampled at its first pixel in
    scan order (the reference's next(ndenumerate) idiom,
    scripts/trajectory_gen.py:618-626) and scaled by 20/255 m.
    """
    label_img = rgb_to_int_image(semantic_img)
    depth = np.asarray(depth_img, dtype=np.float32)
    out = {}
    for packed in np.unique(label_img):
        rgb = (int(packed >> 16) & 0xFF, int(packed >> 8) & 0xFF, int(packed) & 0xFF)
        name = rgb_to_obj.get(rgb)
        if name not in QUERY_OBJECTS:
            continue
        mask = label_img == packed
        # 4-connectivity: the reference builds an 8-connectivity structure but
        # never passes it to scipy's label() (scripts/trajectory_gen.py:648-651)
        comp, n = ndimage.label(mask)
        depths = []
        for i in range(1, n + 1):
            ys, xs = np.nonzero(comp == i)
            first = np.argmin(ys * comp.shape[1] + xs)  # scan-order first pixel
            depths.append(float(depth[ys[first], xs[first]]) * DEPTH_SCALE)
        out[name] = {"count": int(n), "depths": depths}
    return out
