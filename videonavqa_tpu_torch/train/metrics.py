"""Evaluation metrics (a copy of the JAX package's train/metrics.py): numpy
implementations of what the reference harness reports over an epoch's
predictions, per-class accuracy and weighted / micro F1 (sklearn's
f1_score)."""

from __future__ import annotations

import numpy as np


def per_class_accuracies(y_target, y_pred, num_classes):
    """Per-class hit-rate vector; 0.0 for absent classes."""
    y_target = np.asarray(y_target)
    y_pred = np.asarray(y_pred)
    accs = np.zeros(num_classes, dtype=np.float64)
    for i in range(num_classes):
        idx = y_target == i
        total = idx.sum()
        if total:
            accs[i] = (y_pred[idx] == i).sum() / float(total)
    return accs


def f1_score(y_target, y_pred, average="weighted", num_classes=None):
    """sklearn-compatible multiclass F1 ('weighted', 'micro' or 'macro') over
    the label set present in the data (the union of targets and predictions),
    or over range(num_classes) when that is given."""
    y_target = np.asarray(y_target).astype(np.int64)
    y_pred = np.asarray(y_pred).astype(np.int64)
    labels = np.union1d(y_target, y_pred) if num_classes is None else np.arange(num_classes)

    if average == "micro":
        # multiclass micro-F1 == accuracy
        return float((y_target == y_pred).mean()) if y_target.size else 0.0

    f1s, support = [], []
    for c in labels:
        tp = np.sum((y_pred == c) & (y_target == c))
        fp = np.sum((y_pred == c) & (y_target != c))
        fn = np.sum((y_pred != c) & (y_target == c))
        denom = 2 * tp + fp + fn
        f1s.append(2.0 * tp / denom if denom else 0.0)
        support.append(np.sum(y_target == c))
    f1s = np.asarray(f1s)
    support = np.asarray(support, dtype=np.float64)

    if average == "weighted":
        return float(np.sum(f1s * support) / support.sum()) if support.sum() else 0.0
    if average == "macro":
        return float(f1s.mean()) if f1s.size else 0.0
    raise ValueError(f"unknown average {average!r}")
