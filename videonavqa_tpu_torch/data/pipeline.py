"""The host input pipeline (a copy of the JAX package's data/pipeline.py).

- A video is ``<id>.npy`` (``[T, 160, 208, 3]`` uint8 BGR) or, where no
  ``.npy`` exists, ``<id>.mp4`` decoded with OpenCV, imported only then.
- Temporal subsampling keeps one uniformly random frame of each 4-frame
  bucket in a fixed 35-frame zero-padded container. Training draws anew each
  epoch; ``deterministic=True`` (the harness's validation) draws once per
  example, so metrics repeat.
- Questions are zero-padded to 56 tokens.
- Batches stay uint8 on the host; the /255 runs on the device.
- A background thread assembles batches through a decode thread pool into a
  bounded queue.

Train and val drop the trailing partial batch; test pads it up to the batch
size (label 0, q_id 35) and reports the true count as ``num_valid``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from videonavqa_tpu_torch.data.buckets import resolve_frame_buckets
from videonavqa_tpu_torch.utils import constants as C


def load_json(path):
    with open(path, "r") as f:
        return json.load(f)


@dataclasses.dataclass(frozen=True)
class DataPaths:
    """Directory layout of a dataset rooted at ``base_dir``."""

    base_dir: str

    @property
    def questions_dir(self):
        return os.path.join(self.base_dir, "encoded_questions")

    @property
    def videos_dir(self):
        return os.path.join(self.base_dir, "videos")

    @property
    def labels_file(self):
        return os.path.join(self.base_dir, "labels.json")

    @property
    def q_ids_file(self):
        return os.path.join(self.base_dir, "q_ids.json")

    @property
    def split_file(self):
        return os.path.join(self.base_dir, "split.json")

    @property
    def obj_detector_file(self):
        return os.path.join(self.base_dir, "obj_detect.pt")


def _video_num_frames(path_base: str) -> int:
    """Frame count without decoding (npy header / mp4 metadata)."""
    npy = path_base + ".npy"
    if os.path.exists(npy):
        return int(np.load(npy, mmap_mode="r").shape[0])
    import cv2

    cap = cv2.VideoCapture(path_base + ".mp4")
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    return min(max(n, 1), C.MAX_NUM_VIDEO_FRAMES)


def _decode_video(path_base: str) -> np.ndarray:
    """``<path_base>.npy``, else ``<path_base>.mp4`` -> [T, H, W, 3] uint8 BGR."""
    npy = path_base + ".npy"
    if os.path.exists(npy):
        return np.load(npy)
    mp4 = path_base + ".mp4"
    import cv2

    cap = cv2.VideoCapture(mp4)
    frames = []
    while len(frames) < C.MAX_NUM_VIDEO_FRAMES:
        ok, img = cap.read()
        if not ok:
            break
        frames.append(img)
    cap.release()
    if not frames:
        raise IOError(f"could not decode any frames from {mp4}")
    return np.stack(frames)


def subsample_frames(video: np.ndarray, rng: np.random.RandomState, *, dtype=np.uint8):
    """One random frame of each 4-frame bucket into a fixed 35-frame container
    -> ([35, H, W, C], v_len). ``dtype`` is the container's: the serving
    daemon subsamples stored bf16 / fp8 feature planes (their uint16 / uint8
    bits) with the same picks, without widening them."""
    T = min(video.shape[0], C.DROP_EVERY_N_FRAMES * C.MAX_ALLOWED_NUM_FRAMES_DROPPING)
    out = np.zeros((C.MAX_ALLOWED_NUM_FRAMES_DROPPING,) + video.shape[1:], dtype=dtype)
    count = 0
    for i in range(0, T, C.DROP_EVERY_N_FRAMES):
        hi = min(i + C.DROP_EVERY_N_FRAMES, T) - 1
        out[count] = video[rng.randint(i, hi + 1)]
        count += 1
    return out, count


class VNQADataset:
    """Examples of one split: video, question, label (and q_id)."""

    def __init__(self, paths: DataPaths, filenames, labels, *, q_only=False,
                 v_only=False, q_metadata=False, deterministic=False, seed=0):
        if q_only and v_only:
            raise ValueError("a dataset cannot be both question-only and video-only")
        self.paths = paths
        self.filenames = list(filenames)
        self.labels = labels
        self.q_only = q_only
        self.v_only = v_only
        self.q_metadata = q_metadata
        self.deterministic = deterministic
        self.seed = seed
        self.q_ids = load_json(paths.q_ids_file) if q_metadata else None
        self._lengths = None

    def __len__(self):
        return len(self.filenames)

    def _rng_for(self, filename, epoch):
        # crc32, not hash(): str hashes change with PYTHONHASHSEED, and the
        # frame picks must be the same in every process
        key = f"{self.seed}/{filename}" if self.deterministic \
            else f"{self.seed}/{filename}/{epoch}"
        return np.random.RandomState(zlib.crc32(key.encode()) & 0x7FFFFFFF)

    def load_example(self, index: int, epoch: int = 0):
        filename = self.filenames[index]
        ex = {}
        if not self.q_only:
            video = _decode_video(os.path.join(self.paths.videos_dir, filename))
            ex["video"], ex["v_len"] = subsample_frames(video, self._rng_for(filename, epoch))
        if not self.v_only:
            tokens = np.load(os.path.join(self.paths.questions_dir, filename + ".npy"))
            q = np.zeros(C.MAX_Q_LEN, dtype=np.int32)
            q[: tokens.shape[0]] = tokens
            ex["question"] = q
            ex["q_len"] = tokens.shape[0]
        if self.q_metadata:
            ex["q_id"] = self.q_ids[filename]
        ex["label"] = self.labels[filename]
        return ex

    def subsampled_lengths(self):
        """v_len of each example after subsampling (ceil(frames / 4), at most
        35), from the containers' metadata alone."""
        if self._lengths is None:
            raw = [_video_num_frames(os.path.join(self.paths.videos_dir, f))
                   for f in self.filenames]
            self._lengths = np.minimum(-(-np.asarray(raw) // C.DROP_EVERY_N_FRAMES),
                                       C.MAX_ALLOWED_NUM_FRAMES_DROPPING)
        return self._lengths

    def get_class_weights(self, num_classes=C.NUM_CLASSES):
        """Inverse-frequency class weights (1 / max(count, 1)), f32."""
        classes = np.array([self.labels[f] for f in self.filenames])
        counts = np.array([(classes == i).sum() for i in range(num_classes)], dtype=np.float64)
        return (1.0 / np.maximum(counts, 1)).astype(np.float32)


PAD_QID = 35  # q_id of a test batch's padding rows


class BatchLoader:
    """Batches of a ``VNQADataset``, assembled by a background thread.

    modes: 'train' / 'val' shuffle (optionally) and drop the trailing partial
    batch; 'test' pads the last batch to ``batch_size`` (label 0, q_id 35,
    v_len and q_len at least 1) and sets ``num_valid``.
    """

    DEFAULT_FRAME_BUCKETS = C.FRAME_BUCKETS

    def __init__(self, dataset: VNQADataset, batch_size: int, *, shuffle=True,
                 mode="train", num_workers=4, seed=0, prefetch=2,
                 bucket_by_length=False, frame_buckets=None):
        """``bucket_by_length`` puts examples of like length into a batch
        (shuffled ties, shuffled batch order). ``frame_buckets`` (True,
        "auto" or the buckets) trims each batch's frame axis to the smallest
        bucket >= its longest v_len."""
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.mode = mode
        self.num_workers = num_workers
        self.seed = seed
        self.prefetch = prefetch
        self.bucket_by_length = bucket_by_length
        self.frame_buckets = resolve_frame_buckets(
            frame_buckets, self.ds.subsampled_lengths, self.DEFAULT_FRAME_BUCKETS)

    def __len__(self):
        n = len(self.ds)
        if self.mode == "test":
            return (n + self.batch_size - 1) // self.batch_size
        return n // self.batch_size

    def _collate(self, examples, num_valid):
        B = self.batch_size
        batch = {}
        for k in examples[0].keys():
            arrs = [np.asarray(ex[k]) for ex in examples]
            pad = B - len(arrs)
            if pad:
                filler = np.zeros_like(arrs[0])
                if k == "q_id":
                    filler = filler + PAD_QID
                arrs = arrs + [filler] * pad
            batch[k] = np.stack(arrs)
        batch["label"] = batch["label"].astype(np.int32)
        for k in ("v_len", "q_len"):
            if k in batch:
                batch[k] = batch[k].astype(np.int32)
                if self.mode == "test":
                    # padding rows must not break masks that assume a length >= 1
                    batch[k][num_valid:] = np.maximum(batch[k][num_valid:], 1)
        batch["num_valid"] = np.int32(num_valid)
        if self.frame_buckets and "video" in batch:
            t_max = int(batch["v_len"].max())
            t_b = min((t for t in self.frame_buckets if t >= t_max),
                      default=batch["video"].shape[1])
            batch["video"] = batch["video"][:, :t_b]
        return batch

    def epoch(self, epoch: int = 0):
        """Yields the collated numpy batches of one epoch."""
        order = np.arange(len(self.ds))
        # the JAX package's seed expression, kept as it is so that both
        # packages shuffle alike
        rs = np.random.RandomState((self.seed, epoch).__hash__() & 0x7FFFFFFF)
        if self.shuffle:
            rs.shuffle(order)
        if self.bucket_by_length:
            lens = self.ds.subsampled_lengths()[order]
            order = order[np.argsort(-lens, kind="stable")]  # shuffled tie-break

        starts = list(range(0, len(order), self.batch_size))
        if self.mode != "test":
            starts = [s for s in starts if s + self.batch_size <= len(order)]
        if self.bucket_by_length and self.shuffle:
            rs.shuffle(starts)

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()
        closed = threading.Event()

        def put(item):
            """False once the consumer has closed the epoch."""
            while not closed.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for s in starts:
                        idxs = order[s: s + self.batch_size]
                        examples = list(pool.map(
                            lambda i: self.ds.load_example(int(i), epoch), idxs))
                        if not put(self._collate(examples, len(examples))):
                            return
            except BaseException as e:  # raised again on the consumer's side
                put(e)
                return
            put(stop)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # an epoch closed early (e.g. after its first batch) ends its
            # producer and workers too, once the batch in hand is loaded
            closed.set()
            thread.join()
