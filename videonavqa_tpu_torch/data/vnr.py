"""The VNR packed-record dataset: a Python writer and a ctypes binding to the
native C++ batch loader ``native/vnr.cpp`` (a copy of the JAX package's
data/vnr.py).

``pack_dataset`` turns a dataset directory into one ``.vnr`` file per split;
``VNRBatchLoader`` then assembles batches in the library's thread pool
(decompress, 1-of-4 random subsample, pad) with the same ``epoch`` API as
``data.pipeline.BatchLoader``.

The library is built with g++ at first use into the git-ignored
``videonavqa_tpu_torch/_build/``, under a name that carries a digest of the
source, so an edited source is rebuilt. A failed build raises. It links the
zstd runtime by its soname (``libzstd.so.1``) and finds ``zstd.h`` in the
system or else in ``zstd_api/``, which declares the four stable functions the
source calls: a machine may carry the runtime library without its
development files. Feature
payloads (bf16 and fp8 e4m3 frozen-stem features) are read as their raw bits,
``uint16`` and ``uint8`` numpy arrays; ``VNRBatchLoader.torch_dtype`` is the
dtype to view them as in torch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import zlib
from pathlib import Path

import numpy as np
import torch

from videonavqa_tpu_torch.data.buckets import resolve_frame_buckets
from videonavqa_tpu_torch.data.pipeline import PAD_QID, DataPaths, _decode_video, load_json
from videonavqa_tpu_torch.utils import constants as C

_MAGIC = 0x31524E56
SOURCE = Path(__file__).resolve().parents[2] / "native" / "vnr.cpp"
ZSTD_API = Path(__file__).resolve().parent / "zstd_api"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-idirafter", str(ZSTD_API))
GXX_LIBS = ("-lz", "-l:libzstd.so.1", "-lpthread")

_build_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes() + (ZSTD_API / "zstd.h").read_bytes())
    digest = digest.hexdigest()[:12]
    return BUILD_DIR / f"libvnr-{digest}.so"


def ensure_built() -> Path:
    """Compile ``native/vnr.cpp`` into ``_build/`` unless that build exists;
    raises where g++ fails."""
    out = library_path()
    with _build_lock:
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.so")
        cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp), *GXX_LIBS]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {SOURCE} (exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
        return out


def _load_lib():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(ensure_built()))
        lib.vnr_open.restype = ctypes.c_void_p
        lib.vnr_open.argtypes = [ctypes.c_char_p]
        lib.vnr_num_examples.restype = ctypes.c_int
        lib.vnr_num_examples.argtypes = [ctypes.c_void_p]
        lib.vnr_lengths.restype = None
        lib.vnr_lengths.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.vnr_batch.restype = ctypes.c_int
        lib.vnr_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.vnr_frame_info.restype = None
        lib.vnr_frame_info.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.vnr_example_full.restype = ctypes.c_int
        lib.vnr_example_full.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p, ctypes.c_int]
        lib.vnr_close.restype = None
        lib.vnr_close.argtypes = [ctypes.c_void_p]
        lib.vnr_zstd_compress.restype = ctypes.c_int64
        lib.vnr_zstd_compress.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
        lib.vnr_zstd_bound.restype = ctypes.c_int64
        lib.vnr_zstd_bound.argtypes = [ctypes.c_int64]
        _lib = lib
    return _lib


def _zstd_compress(raw: bytes, level: int = 1) -> bytes:
    lib = _load_lib()
    cap = lib.vnr_zstd_bound(len(raw))
    dst = ctypes.create_string_buffer(cap)
    n = lib.vnr_zstd_compress(raw, len(raw), dst, cap, level)
    if n < 0:
        raise RuntimeError("zstd compression failed")
    return dst.raw[:n]


#: frame codec flag (low byte of the header's flags; the high byte is the
#: payload code, see _PAYLOADS)
_CODEC_FLAGS = {None: 0, "raw": 0, "zlib": 1, "zstd": 2, True: 2, False: 0}

#: payload code -> (numpy dtype of the stored bits, batch key, torch dtype);
#: code 0 = video files of the first format version
_PAYLOADS = {
    0: (np.dtype(np.uint8), "video", torch.uint8),
    1: (np.dtype(np.uint8), "video", torch.uint8),
    2: (np.dtype(np.uint16), "v_features", torch.bfloat16),
    3: (np.dtype(np.uint8), "v_features", torch.float8_e4m3fn),
}
_PAYLOAD_CODES = {"u8": 1, "bfloat16": 2, "float8_e4m3": 3}


class RecordWriter:
    """Streaming writer of the VNR container.

    A frame is an opaque [H, W, C] plane whose scalar type ``payload`` names:
    'u8' BGR pixels for video files, or 'bfloat16' / 'float8_e4m3' feature
    values stored as their bits. The data streams to a sidecar file; the
    small index is buffered, and ``close`` assembles the file atomically.
    """

    def __init__(self, out_file, frame_shape, *, payload="u8", compress="zstd",
                 fingerprint=b""):
        self.out_file = out_file
        self.frame_shape = tuple(int(s) for s in frame_shape)
        self.payload_code = _PAYLOAD_CODES[payload]
        self.elem_size = _PAYLOADS[self.payload_code][0].itemsize
        self.codec = _CODEC_FLAGS[compress]
        if len(fingerprint) > 16:
            raise ValueError("a fingerprint is at most 16 bytes")
        self.fingerprint = bytes(fingerprint).ljust(16, b"\0")
        self._index = []
        self._offset = 0
        self._data_path = out_file + ".data.tmp"
        self._data_f = open(self._data_path, "wb")

    def add(self, frames, tokens, label, q_id=0):
        """frames: [T, H, W, C] ndarray whose itemsize is the payload's."""
        frames = np.ascontiguousarray(frames)
        if frames.shape[1:] != self.frame_shape or frames.dtype.itemsize != self.elem_size:
            raise ValueError(f"frames {frames.shape} {frames.dtype} do not fit "
                             f"{self.frame_shape} of {self.elem_size}-byte elements")
        blobs = []
        for frame in frames:
            raw = frame.tobytes()
            if self.codec == 1:
                blobs.append(zlib.compress(raw, 1))
            elif self.codec == 2:
                blobs.append(_zstd_compress(raw))
            else:
                blobs.append(raw)
        tokens = np.asarray(tokens, dtype=np.int64)
        idx = struct.pack("<QI", self._offset, len(blobs))
        idx += struct.pack(f"<{len(blobs)}I", *[len(b) for b in blobs])
        idx += struct.pack("<Iii", len(tokens), int(label), int(q_id))
        idx += tokens.tobytes()
        self._index.append(idx)
        for b in blobs:
            self._data_f.write(b)
            self._offset += len(b)

    def close(self):
        self._data_f.close()
        H, W, Ch = self.frame_shape
        flags = self.codec | (self.payload_code << 8)
        tmp = self.out_file + ".tmp"
        with open(tmp, "wb") as f:
            # header v2: a 16-byte provenance fingerprint after the fields
            f.write(struct.pack("<IIIHHHH", _MAGIC, 2, len(self._index), H, W, Ch, flags))
            f.write(self.fingerprint)
            f.writelines(self._index)
            with open(self._data_path, "rb") as d:
                shutil.copyfileobj(d, f)
        os.remove(self._data_path)
        os.replace(tmp, self.out_file)

    def abort(self):
        """Remove the partial outputs."""
        try:
            self._data_f.close()
        finally:
            for p in (self._data_path, self.out_file + ".tmp"):
                if os.path.exists(p):
                    os.remove(p)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:
            self.abort()
        return False


def read_fingerprint(path):
    """The 16-byte fingerprint of a .vnr / .fnr file, or None for a v1
    header; reads the header alone."""
    with open(path, "rb") as f:
        head = f.read(20)
        if len(head) < 20:
            raise IOError(f"truncated VNR header in {path}")
        magic, version = struct.unpack_from("<II", head)
        if magic != _MAGIC:
            raise IOError(f"{path} is not a VNR file")
        if version < 2:
            return None
        fp = f.read(16)
        if len(fp) < 16:
            raise IOError(f"truncated VNR v2 header in {path}")
        return fp


def pack_dataset(base_dir, out_file, example_ids=None, *, compress="zstd"):
    """Pack (a split of) a dataset directory into a .vnr file.

    ``compress``: 'zstd' (the default), 'zlib', or None / 'raw'. Returns the
    example ids in file order, the loader's index space.
    """
    paths = DataPaths(base_dir)
    labels = load_json(paths.labels_file)
    q_ids = load_json(paths.q_ids_file) if os.path.exists(paths.q_ids_file) else {}
    ids = sorted(example_ids if example_ids is not None else labels)

    with RecordWriter(out_file, (C.VID_HEIGHT, C.VID_WIDTH, 3),
                      payload="u8", compress=compress) as w:
        for ex_id in ids:
            video = _decode_video(os.path.join(paths.videos_dir, ex_id))
            if video.shape[1:] != (C.VID_HEIGHT, C.VID_WIDTH, 3):
                raise ValueError(f"{ex_id}: frames of shape {video.shape[1:]}")
            tokens = np.load(os.path.join(paths.questions_dir, ex_id + ".npy")).astype(np.int64)
            w.add(video, tokens, int(labels[ex_id]), int(q_ids.get(ex_id, 0)))
    return ids


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


class VNRBatchLoader:
    """Batches of a .vnr file, assembled by the native thread pool.

    The same ``epoch()`` / ``len()`` as ``pipeline.BatchLoader`` (train and
    val drop the last partial batch, test pads it; optional length-bucketed
    batches with frame trimming), over both payloads: u8 video files (batch
    key "video") and feature files (batch key "v_features", their bits).

    ``row_slice=(start, size)``: a mesh rank's loader. Every rank composes
    the same global batches (order, frame cap), and this one decodes only
    rows [start, start + size) of each (``parallel/multihost.py
    host_batch_slice``); ``num_valid`` is then this rank's.
    """

    def __init__(self, path, batch_size, *, shuffle=True, mode="train",
                 num_threads=0, seed=0, bucket_by_length=False,
                 frame_buckets=None, deterministic=False, row_slice=None):
        if row_slice is not None:
            start, size = row_slice
            if start < 0 or size < 1 or start + size > batch_size:
                raise ValueError(f"row_slice {row_slice} is not within a batch of {batch_size}")
        self.row_slice = row_slice
        self._lib = _load_lib()
        self._handle = self._lib.vnr_open(os.fsencode(path))
        if not self._handle:
            raise IOError(f"could not open VNR file {path}")
        self.n = self._lib.vnr_num_examples(self._handle)
        info = np.zeros(4, dtype=np.int32)
        self._lib.vnr_frame_info(self._handle, _ptr(info))
        self.frame_shape = tuple(int(s) for s in info[:3])
        self.payload_code = int(info[3])
        if self.payload_code not in _PAYLOADS:
            raise ValueError(f"unsupported VNR payload code {self.payload_code}")
        self.frame_dtype, self.payload_key, self.torch_dtype = _PAYLOADS[self.payload_code]
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.mode = mode
        self.num_threads = num_threads
        self.seed = seed
        self.deterministic = deterministic
        self.bucket_by_length = bucket_by_length
        self._lengths = np.zeros(self.n, dtype=np.int32)
        self._lib.vnr_lengths(self._handle, _ptr(self._lengths))
        self.frame_buckets = resolve_frame_buckets(
            frame_buckets, lambda: self._lengths, C.FRAME_BUCKETS)

    @property
    def lengths(self):
        """Subsampled video length of each example [n], in file order."""
        return self._lengths

    def __len__(self):
        if self.mode == "test":
            return (self.n + self.batch_size - 1) // self.batch_size
        return self.n // self.batch_size

    def close(self):
        if self._handle:
            self._lib.vnr_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def example_frames(self, idx, max_frames=None):
        """Every stored frame of one example, [T, H, W, C], up to
        ``max_frames`` (default 140, the most the subsampler reads)."""
        cap = (C.DROP_EVERY_N_FRAMES * C.MAX_ALLOWED_NUM_FRAMES_DROPPING
               if max_frames is None else max_frames)
        out = np.empty((cap, *self.frame_shape), dtype=self.frame_dtype)
        n = self._lib.vnr_example_full(self._handle, int(idx), _ptr(out), cap)
        if n < 0:
            raise RuntimeError(f"vnr_example_full failed for example {idx}")
        return out[:n]

    def example_meta(self, idx):
        """(tokens, label, q_id) of one example."""
        q = np.empty((1, C.MAX_Q_LEN), dtype=np.int32)
        q_len, label, q_id, v_len = (np.empty(1, dtype=np.int32) for _ in range(4))
        payload = np.empty((1, 1, *self.frame_shape), dtype=self.frame_dtype)
        idx_arr = np.asarray([idx], dtype=np.int32)
        rc = self._lib.vnr_batch(
            self._handle, _ptr(idx_arr), 1, 1, ctypes.c_uint64(0), 0, 1,
            _ptr(payload), _ptr(v_len), _ptr(q), _ptr(q_len), _ptr(label), _ptr(q_id))
        if rc != 0:
            raise RuntimeError(f"vnr_batch failed with status {rc}")
        return q[0, :q_len[0]].astype(np.int64), int(label[0]), int(q_id[0])

    def _load(self, idxs, t_cap, epoch):
        if self.row_slice is not None:
            # only this rank's rows; the order and t_cap are the global batch's
            start, B = self.row_slice
            n_valid = int(np.clip(len(idxs) - start, 0, B))
            idxs = idxs[start:start + B]
        else:
            B = self.batch_size
            n_valid = len(idxs)
        idx_arr = np.zeros(B, dtype=np.int32)
        idx_arr[:n_valid] = idxs
        video = np.empty((B, t_cap, *self.frame_shape), dtype=self.frame_dtype)
        q = np.empty((B, C.MAX_Q_LEN), dtype=np.int32)
        v_len, q_len, label, q_id = (np.empty(B, dtype=np.int32) for _ in range(4))
        rc = self._lib.vnr_batch(
            self._handle, _ptr(idx_arr), B, t_cap, ctypes.c_uint64(self.seed),
            0 if self.deterministic else epoch, self.num_threads, _ptr(video),
            _ptr(v_len), _ptr(q), _ptr(q_len), _ptr(label), _ptr(q_id))
        if rc != 0:
            raise RuntimeError(f"vnr_batch failed with status {rc}")
        if n_valid < B:  # padding rows, as the Python loader's test mode
            video[n_valid:] = 0
            v_len[n_valid:] = 1
            q[n_valid:] = 0
            q_len[n_valid:] = 1
            label[n_valid:] = 0
            q_id[n_valid:] = PAD_QID
        return {self.payload_key: video, "v_len": v_len, "question": q,
                "q_len": q_len, "label": label, "q_id": q_id,
                "num_valid": np.int32(n_valid)}

    def epoch(self, epoch=0):
        order = np.arange(self.n)
        # the JAX package's seed expression, kept so both packages shuffle alike
        rs = np.random.RandomState((self.seed, epoch).__hash__() & 0x7FFFFFFF)
        if self.shuffle:
            rs.shuffle(order)
        if self.bucket_by_length:
            order = order[np.argsort(-self._lengths[order], kind="stable")]
        starts = list(range(0, self.n, self.batch_size))
        if self.mode != "test":
            starts = [s for s in starts if s + self.batch_size <= self.n]
        if self.bucket_by_length and self.shuffle:
            rs.shuffle(starts)
        for s in starts:
            idxs = order[s: s + self.batch_size]
            t_max = int(self._lengths[idxs].max())
            if self.frame_buckets:
                t_cap = min((t for t in self.frame_buckets if t >= t_max),
                            default=C.MAX_ALLOWED_NUM_FRAMES_DROPPING)
            else:
                t_cap = C.MAX_ALLOWED_NUM_FRAMES_DROPPING
            yield self._load(idxs, t_cap, epoch)
