"""Faults planted under the timed path, to read what the check makes of them
(``run.py --fault <name>`` on the card; the CPU tests plant the same ones).
Each is a context manager that patches the measured package while it is
open:

- ``altered_answer``: the first answer of every fetched batch shifted by one
  class, where the engine produces it;
- ``half_batch``: the train step's loss taken as the mean over the first
  half of the batch's rows;
- ``unchanged_state``: an optimizer step that leaves the parameters and
  Adam's state as they were.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(owner, name, value):
    saved = vars(owner)[name]          # as stored: a staticmethod stays one
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, saved)


def altered_answer():
    import numpy as np
    from videonavqa_tpu_torch.serve.engine import InferenceEngine

    fetch = InferenceEngine.fetch

    def altered(handle):
        probs = np.array(fetch(handle))
        probs[0] = np.roll(probs[0], 1)
        return probs

    return _patched(InferenceEngine, "fetch", staticmethod(altered))


def half_batch():
    from videonavqa_tpu_torch.train import step as step_mod

    loss = step_mod.cross_entropy_loss

    def half(logits, labels, **kw):
        n = max(1, logits.shape[0] // 2)
        return loss(logits[:n], labels[:n], **kw)

    return _patched(step_mod, "cross_entropy_loss", half)


def unchanged_state():
    import torch

    return _patched(torch.optim.Adam, "step", lambda self, closure=None: None)


FAULTS = {"altered_answer": altered_answer, "half_batch": half_batch,
          "unchanged_state": unchanged_state}
