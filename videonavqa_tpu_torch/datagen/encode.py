"""Question tokenization and encoding (a copy of the JAX package's
datagen/encode.py; the reference's scripts/encode_questions.py).

Tokens match the reference regex ``[\\w']+|/|\\?`` lowercased; the vocabulary
is built in first-appearance order over the question files and tokens are
encoded as 1-based indices (0 = pad). One deliberate fix: files are processed
in sorted order (the reference iterates os.listdir, making its vocab order
filesystem-dependent)."""

from __future__ import annotations

import json
import os
import re

import numpy as np

TOKEN_RE = re.compile(r"[\w']+|/|\?")


def tokenize(text: str):
    return [t.lower() for t in TOKEN_RE.findall(text)]


def _iter_question_files(data_dir):
    for filename in sorted(os.listdir(data_dir)):
        if filename.endswith(".json"):
            with open(os.path.join(data_dir, filename)) as f:
                yield filename.split(".")[0], json.load(f)


def build_vocab(data_dir):
    """token -> 1-based index, in first-appearance order."""
    vocab = {}
    for _, data in _iter_question_files(data_dir):
        for entry in data.values():
            for tok in tokenize(entry["q_text"]):
                if tok not in vocab:
                    vocab[tok] = len(vocab) + 1
    return vocab


def encode_questions(data_dir, save_dir, vocab=None):
    """Write per-example <house>_<traj:04d>.npy encodings; returns
    (vocab, question_lengths)."""
    vocab = vocab if vocab is not None else build_vocab(data_dir)
    os.makedirs(save_dir, exist_ok=True)
    q_lens = []
    for house_id, data in _iter_question_files(data_dir):
        for traj_id, entry in data.items():
            enc = np.array([vocab[t] for t in tokenize(entry["q_text"])],
                           dtype=np.int64)
            q_lens.append(enc.shape[0])
            np.save(os.path.join(save_dir, "%s_%04d.npy" % (house_id, int(traj_id))), enc)
    return vocab, np.array(q_lens)
