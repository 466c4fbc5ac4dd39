"""Precompute frozen-stem features into a feature-cache .fnr file (the port of
the JAX package's cli/extract_features.py).

The stem is frozen, so its features are a function of the pixels alone. This
entry point runs it once over every raw frame of a packed dataset and stores
the [10, 13, 512] feature planes in the VNR container the native loader reads
(``data/vnr.py``); the harness then trains and validates the trunk alone
(``--feature_cache``) and the serving daemon answers from the planes. The
loader's (seed, example, epoch) 1-of-4 frame pick applies unchanged: the cache
holds every raw frame the subsampler can pick.

The planes are stored as bf16 (``--feature_dtype bfloat16``) or fp8 e4m3
(``float8_e4m3``; half the bytes), each f32 feature rounded once (the stem's
last op, an eval BatchNorm, runs in f32), as the raw bits of
``torch.bfloat16`` / ``torch.float8_e4m3fn``.
Frames go through the stem in chunks of ``--chunk`` frames, sized down to the
split's longest video; on the card VGG block 1 runs through the
``vgg_block1`` kernel, once a chunk.

Each file records the fingerprint of the stem that wrote it
(``stem_fingerprint``), which names the port's backend: a cache the JAX
package's stem wrote is stale here, and the other way round (the two stems
agree only within bf16 ulps).

    python -m videonavqa_tpu_torch.cli.extract_features --data_dir data/ \\
        --splits train,val,test [--feature_dtype float8_e4m3] [--device cpu]
"""

from __future__ import annotations

import argparse
import hashlib
import os
import time

import numpy as np
import torch

from videonavqa_tpu_torch.data.pipeline import DataPaths, load_json
from videonavqa_tpu_torch.data.vnr import (
    RecordWriter, VNRBatchLoader, ensure_built, pack_dataset, read_fingerprint)
from videonavqa_tpu_torch.ops.video import normalize_video
from videonavqa_tpu_torch.utils import constants as C
from videonavqa_tpu_torch.utils.device import resolve_device

FEATURE_SHAPE = (C.STEM_OUT_H, C.STEM_OUT_W, C.STEM_OUT_CHANNELS)

#: the stored planes' torch dtype and the numpy dtype of their bits
STORE_DTYPES = {"bfloat16": (torch.bfloat16, torch.int16, np.uint16),
                "float8_e4m3": (torch.float8_e4m3fn, torch.uint8, np.uint8)}

#: bump when the stem computation itself changes incompatibly (feature
#: geometry, normalization, layer set): invalidates every existing cache
_STEM_CODE_VERSION = b"stem-v1"

_FINGERPRINT_CACHE = {}


def feature_file(data_dir: str, split: str, feature_dtype: str = "bfloat16") -> str:
    tag = "_fp8" if feature_dtype == "float8_e4m3" else ""
    return os.path.join(data_dir, f"features_{split}{tag}.fnr")


def _hash_file_into(h, path: str):
    with open(path, "rb") as f:
        while chunk := f.read(1 << 20):
            h.update(chunk)


def stem_fingerprint(args, paths) -> bytes:
    """16-byte provenance hash of the stem a feature cache was (or would be)
    extracted with: the resolved VGG and detector weight files (their
    contents, or the seeded random-init marker where a file is absent, by
    ``load_stem``'s rules), the extraction ``--compute_dtype`` and the
    backend that runs the stem (``torch-cuda`` or ``torch-cpu``).

    Memoized on (resolved paths, mtime, size, dtype, backend): a cold call
    reads the whole weight files."""
    frcnn_path = getattr(args, "frcnn_pretrained_path", None)
    vgg = frcnn_path if frcnn_path and os.path.exists(frcnn_path) else None
    det = paths.obj_detector_file if os.path.exists(paths.obj_detector_file) else None
    dtype = str(getattr(args, "compute_dtype", "bfloat16"))
    backend = torch.device(getattr(args, "device", None) or "cuda").type

    def sig(p):
        return (p, os.path.getmtime(p), os.path.getsize(p)) if p else None

    key = (sig(vgg), sig(det), dtype, backend)
    if key in _FINGERPRINT_CACHE:
        return _FINGERPRINT_CACHE[key]
    h = hashlib.blake2b(digest_size=16)
    h.update(_STEM_CODE_VERSION)
    if vgg:
        h.update(b"vgg-file:")
        _hash_file_into(h, vgg)
    else:
        h.update(b"vgg-random:1234")  # load_stem's seeded init
    if det:
        h.update(b"det-file:")
        _hash_file_into(h, det)
    else:
        h.update(b"det-random:1234")
    h.update(b"dtype:" + dtype.encode())
    h.update(b"backend:torch-" + backend.encode())
    digest = h.digest()
    _FINGERPRINT_CACHE[key] = digest
    return digest


def features_needed(args, paths, splits, quiet=False) -> list:
    """Splits whose feature cache is missing or stale (its recorded stem
    fingerprint differs from the stem these args resolve to; a v1 file
    records none)."""
    dtype = getattr(args, "feature_dtype", "bfloat16") or "bfloat16"
    want = stem_fingerprint(args, paths)
    needed = []
    for split in splits:
        out = feature_file(args.data_dir, split, dtype)
        if not os.path.exists(out):
            needed.append(split)
            continue
        have = read_fingerprint(out)
        if have != want:
            if not quiet:
                print(f"=> STALE feature cache {out}: recorded stem fingerprint "
                      f"{'(none, v1 file)' if have is None else have.hex()} != current stem "
                      f"{want.hex()} - re-extracting it")
            needed.append(split)
    return needed


def chunk_frames(lengths, chunk: int = 128) -> int:
    """Frames per stem call for a split: ``chunk``, cut down to the split's
    longest raw video in multiples of 8 (``lengths`` are the subsampled
    ceil(t/4), so 4x bounds the raw t)."""
    max_raw = min(int(np.max(lengths, initial=1)) * C.DROP_EVERY_N_FRAMES,
                  C.DROP_EVERY_N_FRAMES * C.MAX_ALLOWED_NUM_FRAMES_DROPPING)
    return min(chunk, max(8, -(-max_raw // 8) * 8))


def extract_split(args, stem_fn, split: str, ids, fingerprint=None) -> str:
    """Extract one split's features -> the output path. ``stem_fn`` is
    ``load_stem``'s (video /255 [B, T, 160, 208, 3] -> f32 features); the
    split is packed into ``{split}.vnr`` first where that file is missing.
    The stem fingerprint goes into the output's header."""
    if fingerprint is None:
        fingerprint = stem_fingerprint(args, DataPaths(args.data_dir))
    device = resolve_device(getattr(args, "device", None))
    src = os.path.join(args.data_dir, f"{split}.vnr")
    if not os.path.exists(src):
        print(f"=> Packing {split} split into {src}")
        pack_dataset(args.data_dir, src, ids)
    payload = getattr(args, "feature_dtype", "bfloat16") or "bfloat16"
    store_dtype, bits_dtype, np_bits = STORE_DTYPES[payload]
    loader = VNRBatchLoader(src, 1, shuffle=False, mode="test")
    chunk = chunk_frames(loader.lengths, getattr(args, "chunk", 128))
    out = feature_file(args.data_dir, split, payload)
    writer = RecordWriter(out, FEATURE_SHAPE, payload=payload,
                          compress=getattr(args, "compress", "zstd"), fingerprint=fingerprint)
    t0, n_frames = time.time(), 0
    with writer:
        for i in range(loader.n):
            frames = loader.example_frames(i)   # [T, 160, 208, 3] u8, T <= 140
            tokens, label, q_id = loader.example_meta(i)
            t = frames.shape[0]
            feats = []
            for s in range(0, t, chunk):
                block = torch.zeros((chunk, *frames.shape[1:]), dtype=torch.uint8)
                block[:min(chunk, t - s)] = torch.from_numpy(frames[s:s + chunk])
                f = stem_fn(normalize_video(block.to(device)[None]))[0]
                feats.append(f.to(store_dtype).view(bits_dtype).cpu())
            feats = torch.cat(feats)[:t].numpy().view(np_bits)
            writer.add(feats, tokens, label, q_id)
            n_frames += t
            if (i + 1) % 50 == 0:
                print(f"   {split}: {i + 1}/{loader.n} examples "
                      f"({n_frames / (time.time() - t0):.0f} frames/s)")
    loader.close()
    print(f"=> Wrote {out} ({loader.n} examples, {n_frames} frames, "
          f"{os.path.getsize(out) / 1e6:.1f} MB, {time.time() - t0:.1f}s)")
    return out


def ensure_features(args, stem_fn, splits, split_map) -> dict:
    """Extract every missing or stale feature file -> {split: path}.
    ``stem_fn`` may be None where every cache is current."""
    paths = DataPaths(args.data_dir)
    dtype = getattr(args, "feature_dtype", "bfloat16") or "bfloat16"
    needed = set(features_needed(args, paths, splits))
    if needed and stem_fn is None:
        raise ValueError(f"feature caches for splits {sorted(needed)} are missing or stale "
                         "but no stem was provided to re-extract them")
    fp = stem_fingerprint(args, paths)
    outs = {}
    for split in splits:
        if split in needed:
            print(f"=> Extracting frozen-stem features for split '{split}'")
            outs[split] = extract_split(args, stem_fn, split, split_map[split], fingerprint=fp)
        else:
            outs[split] = feature_file(args.data_dir, split, dtype)
    return outs


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--splits", type=str, default="train,val,test")
    parser.add_argument("--frcnn_pretrained_path", type=str, default=None)
    parser.add_argument("--chunk", type=int, default=128,
                        help="frames per stem call (140-frame videos take at most 2 calls)")
    parser.add_argument("--compress", type=str, default="zstd", choices=["zstd", "zlib", "raw"])
    parser.add_argument("--feature_dtype", type=str, default="bfloat16",
                        choices=["bfloat16", "float8_e4m3"],
                        help="fp8 halves the cache's bytes (and rounds each feature coarser)")
    parser.add_argument("--compute_dtype", type=str, default="bfloat16",
                        choices=["bfloat16", "float32"], help="the stem's compute dtype")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (the default) or 'cpu'")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    from videonavqa_tpu_torch.cli.common import load_stem

    device = resolve_device(args.device)
    ensure_built()
    paths = DataPaths(args.data_dir)
    split_map = load_json(paths.split_file)
    stem_fn = load_stem(args, paths, device)
    for split in args.splits.split(","):
        extract_split(args, stem_fn, split, split_map[split])


if __name__ == "__main__":
    main()
