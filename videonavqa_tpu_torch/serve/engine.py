"""Serving engine: padded fixed-shape micro-batches through one loaded model
(the port of the JAX package's ``cli/serve.py`` InferenceEngine).

The model loads once, and each micro-batch is padded to ``max_batch`` rows
(padding rows have v_len = q_len = 1) and its frame axis trimmed to the
smallest frame bucket that covers its longest video (35 frames without
buckets). What an item carries depends on the model and the mode:
precomputed frozen-stem features for a model that ``uses_stem``, raw uint8
frames ``[T, 160, 208, 3]`` for one that takes video itself or, in video mode
(``from_video=True``), for a stem model too, and nothing visual for a
question-only model. In video mode a stem model's frames go /255, then
through the frozen stem in ``cfg.compute_dtype``, VGG block 1 through its
kernel where ``cfg.use_pallas_kernels`` asks for it, or, with the daemon's
``--int8_stem true``, through the int8 stem (``stem/quant.py``), calibrated
at start-up on one stored video (``stem_calibration_batch``; a ``reload``
leaves that calibration as it is, the stem being frozen). With the int8
trunk, the first micro-batch runs the f32 calibration forward on the padded batch
exactly as it stands (padding rows enter the absmax; in video mode on the
stem's output) and every later batch serves static int8 from the recorded
state.

For the daemon (``cli/serve.py``), ``from_args`` builds the engine from its
flags, and the engine also carries:

- the feature-cache mode (``--feature_cache true``): the split's
  ``features_{split}[_fp8].fnr`` opened through the native loader, refused at
  start-up when its recorded stem fingerprint is not the current stem's;
  requests name packed examples by id, whose decoded planes an LRU keeps;
- ``encode_question``, ``load_video`` and ``load_example``, whose 1-of-4
  frame picks draw from one ``np.random.RandomState(seed)`` under a lock;
- the weights as one ``(params, state)`` tuple with a version: a hot
  ``reload`` swaps the tuple and re-arms int8 calibration, and a calibration
  commits only if the version it ran on is still current; a C3D model's
  precomputed zero-run (``state['c3d_zero']``, the columns the cached splice
  reads at each frame bucket it takes) is computed from the new weights
  before they are swapped in, in the same tuple, so no batch runs new
  weights with an old zero-run;
- ``dispatch_batch``, which stages the batch's host arrays into pinned
  memory, copies them on a side stream, enqueues the forward and the softmax
  and a copy of the probabilities back, and returns before the card has run
  them; ``fetch`` waits for that batch alone. Each batch stages into its own
  pinned buffer, which PyTorch's caching host allocator does not hand out
  again until the copy that reads it has run.

The forward runs under ``torch.inference_mode()`` in the thread that calls
it: a request thread's mode does not carry over to the batcher's threads.

Mesh serving (``mesh``: a single-process ``parallel.make_mesh``; the
daemon's ``--mesh_devices N [--model_parallel M]``) is single-process, as
the JAX daemon's: a replica of the weights on every device, the widest
projections' rows split over a data row's 'model' devices
(``param_shardings``), the micro-batch's rows split over the 'data' devices
(``--max_batch`` must divide by them). Each device's forward runs in a
thread of its own under ``parallel.collectives.thread_rank``, its batch
statistics (the attention mask's longest video, the dynamic int8 absmax,
the calibration's) over the whole micro-batch, and the logits of each data
row's first device are gathered on the first device. A reload or an int8
calibration replaces every replica at once, under the weights lock.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import threading
from concurrent.futures import FIRST_EXCEPTION, ThreadPoolExecutor, wait

import numpy as np
import torch

from videonavqa_tpu_torch.datagen.encode import tokenize
from videonavqa_tpu_torch.models import get_model
from videonavqa_tpu_torch.models import v_only_cnn3d
from videonavqa_tpu_torch.models.base import DTYPES
from videonavqa_tpu_torch.ops.video import normalize_video
from videonavqa_tpu_torch.parallel import collectives
from videonavqa_tpu_torch.parallel.mesh import param_shardings, put_global, shard_batch
from videonavqa_tpu_torch.stem import (
    STEM_SEED, init_obj_detector, init_vgg_partial, stem_features)
from videonavqa_tpu_torch.train.step import forward
from videonavqa_tpu_torch.utils import checkpoint as ckpt
from videonavqa_tpu_torch.utils import constants as C
from videonavqa_tpu_torch.utils.device import resolve_device, tree_map, tree_to

# the models on the C3D trunk, whose frame-bucketed batches read a zero-run
C3D_MODELS = ("v_only_cnn3d", "concat3d")

# numpy carries bf16 and fp8 e4m3 planes as their bits
_BITS = {torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.uint8}


def _host_view(t):
    """A numpy view of a CPU tensor (of its bits for bf16 and fp8)."""
    return t.view(_BITS[t.dtype]).numpy() if t.dtype in _BITS else t.numpy()


def stem_calibration_batch(args, paths, rng):
    """The int8 stem's calibration batch of the daemon in video mode: one
    stored video (``--int8_stem_calibration_video``, else the alphabetically
    first ``.mp4`` or ``.npy`` under ``videos/``), subsampled with ``rng``
    (the engine's frame picks), trimmed to its ``v_len`` frames (zero padding
    adds nothing to an absmax) -> f32 [1, v_len, 160, 208, 3], pixels /255."""
    from videonavqa_tpu_torch.data.pipeline import _decode_video, subsample_frames

    name = getattr(args, "int8_stem_calibration_video", None)
    if not name:
        try:
            name = sorted(f for f in os.listdir(paths.videos_dir)
                          if f.endswith((".mp4", ".npy")))[0]
        except (FileNotFoundError, IndexError):
            raise SystemExit(
                "--int8_stem serving calibrates on a stored video at startup but none were "
                f"found in {paths.videos_dir}; pass --int8_stem_calibration_video <path>")
    path = name if os.path.isabs(name) else os.path.join(paths.videos_dir, name)
    for ext in (".mp4", ".npy"):
        if path.endswith(ext):
            path = path[:-len(ext)]
    frames, v_len = subsample_frames(_decode_video(path), rng)
    print(f"=> int8 stem: calibrating on {name} ({v_len} frames)")
    calib = frames[None, :max(int(v_len), 1)]
    return torch.from_numpy(np.ascontiguousarray(calib)).float() / 255.0


class InferenceEngine:
    """Loads the model once; serves padded fixed-shape micro-batches.

    Weights come from a checkpoint (``checkpoint_path``: the JAX package's
    npz or a reference ``torch.save`` file, read into the leaves of the
    model's init: each must be in the file with its shape) or from the
    reference init drawn from
    ``torch.Generator().manual_seed(seed)``. ``device`` defaults to the card;
    pass ``"cpu"`` to run the plain path. A model that draws at eval draws
    each batch from a generator seeded ``seed``, so a repeated request gets
    the same answer (the JAX daemon runs every batch with ``PRNGKey(0)``).

    ``from_video`` is the inverse of the JAX daemon's ``--feature_cache``: a
    stem model is then served from raw uint8 frames through the frozen stem,
    ``stem``: a callable (``cli/common.py load_stem``'s, video /255 ->
    features) or the stem's weights ``(vgg_params, det_params, det_state)``
    (e.g. from ``utils.checkpoint.stem_from_jax``), else the reference init
    drawn from ``torch.Generator().manual_seed(1234)``, the seed number of the
    JAX package's random stem (the two generators give different weights),
    with as many detector filters as the model has input channels; under a
    mesh over several devices, ``stem`` may also be {device: callable}. A
    model that takes video itself is served from frames either way; a
    question-only model has no video mode and raises.

    ``mesh``: a single-process mesh (``parallel.make_mesh(..., devices=)``)
    to serve on; ``device`` is then its first device."""

    def __init__(self, cfg, *, checkpoint_path=None, seed=0, max_batch=8,
                 frame_buckets=C.FRAME_BUCKETS, device=None, from_video=False, stem=None,
                 mesh=None):
        self.mesh = mesh
        if mesh is not None:
            if mesh.process:
                raise ValueError("mesh serving is single-process: pass a mesh over devices")
            if max_batch % mesh.shape["data"]:
                raise ValueError(f"max_batch {max_batch} must divide by the 'data' mesh axis "
                                 f"({mesh.shape['data']})")
            device = mesh.devices[0]
            # one thread a device; one micro-batch on the mesh at a time
            self._pool = ThreadPoolExecutor(max_workers=mesh.size, thread_name_prefix="mesh")
            self._mesh_lock = threading.Lock()
        self.device = resolve_device(device)
        self.cfg = cfg
        self.spec = get_model(cfg.model)
        if from_video and not self.spec.needs_video:
            raise ValueError(f"{cfg.model} takes no video: video mode serves a model that "
                             "uses the frozen stem or takes raw frames")
        self.stem = None
        self.stem_is_int8 = False    # from_args sets it: --int8_stem in video mode
        if from_video and self.spec.uses_stem:
            if stem is None:
                gen = torch.Generator().manual_seed(STEM_SEED)
                vgg = init_vgg_partial(gen)
                det, det_state = init_obj_detector(gen, num_filters=cfg.num_input_channels)
                stem = (vgg, det, det_state)
            self.stem = stem if callable(stem) or isinstance(stem, dict) else \
                tuple(tree_to(t, self.device) for t in stem)
            if mesh is not None and isinstance(self.stem, tuple):
                self.stem = {d: tuple(tree_to(t, d) for t in self.stem)
                             for d in set(mesh.devices)}
        self.visual_key = ("v_features" if self.spec.uses_stem and not from_video
                           else "video" if self.spec.needs_video else None)
        self.seed = seed
        self.B = max_batch
        self.frame_buckets = tuple(frame_buckets) if frame_buckets else ()
        self._calibrate_cfg = dataclasses.replace(cfg, int8_trunk_calibrate=True)
        # The model's init: the template every checkpoint is read into
        # (shapes and dtypes on the meta device), and its state, which stands
        # where a checkpoint holds none.
        params, state = self.spec.init(torch.Generator().manual_seed(seed), cfg,
                                       torch.device("cpu"))
        self._template = (tree_to(params, "meta"), tree_map(torch.clone, state))
        # weights swap and commit: _load_weights bumps the version under the
        # lock; an int8 calibration commits only if its version is current
        self._weights_lock = threading.Lock()
        self._weights_version = 0
        self._needs_int8_calibration = False
        self.checkpoint_path = checkpoint_path
        self.epoch = self._load_weights(checkpoint_path, (params, state))

        # items' frames as numpy: their torch dtype where it is not numpy's
        # own (the bits of cached bf16 / fp8 planes; set by the cache mode),
        # and the shape of one frame
        self.frame_dtype = None
        self.frame_shape = {"video": (C.VID_HEIGHT, C.VID_WIDTH, 3),
                            "v_features": (C.STEM_OUT_H, C.STEM_OUT_W, cfg.num_input_channels),
                            None: None}[self.visual_key]
        self.feature_loader = None
        self.stem_fingerprint_hex = None
        self.paths = None
        self.vocab = None
        # handler threads share this RandomState (frame picks) under a lock
        self.rng = np.random.RandomState(seed)
        self._rng_lock = threading.Lock()

    # --- construction from the daemon's flags --------------------------------

    @classmethod
    def from_args(cls, args):
        """The engine of ``cli/serve.py``'s flags. Unported models and flags
        exit naming their ROADMAP item; ``--feature_cache true`` opens the
        serve split's feature file (a stem model only), refused when its stem
        fingerprint is not the current stem's; without it a stem model is
        served from video through ``load_stem``'s stem."""
        from videonavqa_tpu_torch.cli.common import cfg_from_args, load_stem, refuse_unported
        from videonavqa_tpu_torch.data.pipeline import DataPaths, load_json
        from videonavqa_tpu_torch.parallel.mesh import local_devices, make_mesh

        refuse_unported(args, args.model, batch_flag="max_batch")
        if getattr(args, "distributed", False):
            raise SystemExit("mesh serving is single-process (a replica owns its devices; "
                             "replicas scale behind a load balancer): drop --distributed")
        device = resolve_device(args.device)
        mesh = None
        if getattr(args, "mesh_devices", 0):
            mesh = make_mesh(args.mesh_devices, args.model_parallel or 1,
                             devices=local_devices(device.type))
            device = mesh.devices[0]
        cfg = cfg_from_args(args, args.model)
        use_kernels = args.use_pallas_kernels
        if use_kernels is None:   # on the card, on; on the CPU, the plain versions
            use_kernels = device.type == "cuda"
        cfg = dataclasses.replace(cfg, use_pallas_kernels=bool(use_kernels))
        spec = get_model(args.model)
        paths = DataPaths(args.data_dir)
        cached = bool(getattr(args, "feature_cache", False))
        loader, fingerprint, split_ids = None, None, None
        if cached:
            if not spec.uses_stem:
                raise SystemExit(f"--feature_cache serving requires a frozen-stem model; "
                                 f"{args.model} consumes raw video and has no cached-feature "
                                 "input")
            from videonavqa_tpu_torch.cli.extract_features import feature_file, stem_fingerprint
            from videonavqa_tpu_torch.data.vnr import VNRBatchLoader, read_fingerprint

            split = getattr(args, "serve_split", "test")
            path = feature_file(args.data_dir, split, args.feature_dtype)
            if not os.path.exists(path):
                raise SystemExit(f"--feature_cache serving requires {path} (run "
                                 "videonavqa_tpu_torch.cli.extract_features first)")
            have, want = read_fingerprint(path), stem_fingerprint(args, paths)
            if have != want:
                raise SystemExit(f"feature cache {path} was extracted with a different stem "
                                 f"({have.hex() if have else 'v1 file, none recorded'} != "
                                 f"{want.hex()}); re-extract it before serving")
            loader = VNRBatchLoader(path, 1, shuffle=False, mode="test")
            fingerprint = want.hex()
            split_ids = sorted(load_json(paths.split_file)[split])

        buckets = getattr(args, "bucket_frames", False)
        if buckets == "auto" and loader is not None:
            from videonavqa_tpu_torch.data.buckets import resolve_frame_buckets

            # the edges that cost least for the stored container's own lengths
            buckets = resolve_frame_buckets("auto", lambda: loader.lengths, C.FRAME_BUCKETS)
        elif buckets:
            if buckets == "auto":
                print("=> --bucket_frames auto needs --feature_cache; using the default "
                      "bucket grid")
            buckets = C.FRAME_BUCKETS
        else:
            buckets = None

        from_video = spec.uses_stem and not cached
        # the frame picks of requests come from this RandomState, after the
        # calibration video's, as in the JAX daemon
        rng = np.random.RandomState(args.seed)
        calib = None
        if from_video and getattr(args, "int8_stem", False):
            calib = stem_calibration_batch(args, paths, rng)
        stem = None
        if from_video:   # one stem a device
            stems = {d: load_stem(args, paths, d, calibration_video=calib)
                     for d in (set(mesh.devices) if mesh is not None else {device})}
            stem = stems[device] if len(stems) == 1 else stems
        eng = cls(cfg, checkpoint_path=args.checkpoint_path, seed=args.seed,
                  max_batch=args.max_batch, frame_buckets=buckets, device=device,
                  from_video=from_video, stem=stem, mesh=mesh)
        eng.stem_is_int8 = calib is not None
        eng.rng = rng
        eng.paths = paths
        vocab_path = os.path.join(args.data_dir, "vocab.json")
        eng.vocab = load_json(vocab_path) if os.path.exists(vocab_path) else None
        if loader is not None:
            eng.feature_loader = loader
            eng.stem_fingerprint_hex = fingerprint
            # the feature file's order is the sorted split ids (pack_dataset)
            eng.id_to_idx = {n: i for i, n in enumerate(split_ids)}
            # an LRU of decoded planes: a full example's decode is ~19 MB of
            # work (bf16), so hot examples are served from memory
            eng._example_cache = collections.OrderedDict()
            eng._example_cache_size = max(0, getattr(args, "example_cache", 64))
            eng._decode_lock = threading.Lock()
            eng.frame_shape = loader.frame_shape
            eng.frame_dtype = loader.torch_dtype
        return eng

    # --- weights ---------------------------------------------------------------

    def _load_weights(self, path, init=None):
        """Read a checkpoint (or take ``init``, the model's init, where there
        is no path) and swap it in as one ``(params, state)`` tuple, so a
        batch runs wholly on the old weights or wholly on the new; bumps the
        version and re-arms int8 calibration. A C3D model's zero-run is
        computed from these weights first and goes into the tuple's state.
        -> the checkpoint's epoch."""
        meta = {}
        if path:
            if not os.path.exists(path):
                raise ValueError(f"checkpoint {path!r} does not exist")
            params = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype), self._template[0])
            state = tree_map(torch.clone, self._template[1])   # read in place
            meta = ckpt.load_any_checkpoint(path, model_name=self.cfg.model, cfg=self.cfg,
                                            params=params, state=state)
        elif init is not None:
            params, state = init
        else:
            params, state = self.spec.init(torch.Generator().manual_seed(self.seed), self.cfg,
                                           torch.device("cpu"))
        weights = (tree_to(params, self.device), tree_to(state, self.device))
        zero_run = self._zero_run(*weights)
        if zero_run is not None:
            weights = (weights[0], {**weights[1], "c3d_zero": zero_run})
        if self.mesh is not None:
            weights = self._replicas(*weights)
        with self._weights_lock:
            self._weights = weights
            self._weights_version += 1
            self._needs_int8_calibration = bool(self.cfg.use_int8_trunk)
        return int(meta.get("epoch", 0))

    def _replicas(self, params, state):
        """One (params, state) a mesh rank: its rows of the 'model'-sharded
        leaves, the rest whole, on its device."""
        specs = param_shardings(params, self.mesh)
        return tuple((put_global(params, specs, r),
                      tree_map(lambda t: t.to(r.device, copy=True), state))
                     for r in self.mesh.ranks)

    def _zero_run(self, params, state):
        """A C3D model's precomputed zero-run for each frame bucket the cached
        splice takes (``v_only_cnn3d.precompute_c3d_zero_slices``), or None."""
        if self.cfg.model not in C3D_MODELS:
            return None
        widths = [t for t in self.frame_buckets
                  if 0 < t <= min(v_only_cnn3d.SPLICE_MAX_T_CACHED, self.cfg.max_num_frames - 1)]
        if not widths:
            return None
        return v_only_cnn3d.precompute_c3d_zero_slices(params, state, self.cfg, widths)

    @property
    def params(self):
        """The weights (under a mesh, the first device's replica)."""
        return self._replica(self._weights)[0]

    @property
    def state(self):
        return self._replica(self._weights)[1]

    def _replica(self, weights):
        return weights if self.mesh is None else weights[0]

    @property
    def needs_int8_calibration(self):
        return self._needs_int8_calibration

    @property
    def weights_version(self):
        return self._weights_version

    def reload(self, path=None):
        """Swap in the weights of ``path`` (by default the checkpoint the
        engine started with, e.g. after a trainer overwrote it) -> its epoch.
        The next micro-batch calibrates the int8 trunk anew."""
        self.epoch = self._load_weights(path or self.checkpoint_path)
        return self.epoch

    # --- requests ----------------------------------------------------------------

    def encode_question(self, text):
        if self.vocab is None:
            raise ValueError("no vocab.json in data_dir - cannot tokenize")
        tokens = []
        for tok in tokenize(text):
            if tok not in self.vocab:
                raise ValueError(f"token {tok!r} not in the dataset vocabulary")
            tokens.append(self.vocab[tok])
        return tokens[:C.MAX_Q_LEN]

    def load_video(self, path):
        """Decode and subsample one stored video -> ([35, 160, 208, 3] u8, v_len)."""
        from videonavqa_tpu_torch.data.pipeline import _decode_video, subsample_frames

        if self.feature_loader is not None:
            raise ValueError('this server serves precomputed examples - POST '
                             '{"example": "<id>", ...} instead of "video"')
        if not os.path.isabs(path):
            path = os.path.join(self.paths.videos_dir, path)
        for ext in (".mp4", ".npy"):
            if path.endswith(ext):
                path = path[:-len(ext)]
        if not any(os.path.exists(path + ext) for ext in (".npy", ".mp4")):
            raise FileNotFoundError(f"no video {path}.npy or {path}.mp4")
        raw = _decode_video(path)
        with self._rng_lock:
            frames, v_len = subsample_frames(raw, self.rng)
        return frames, v_len

    def load_example(self, name):
        """Feature-cache mode: the 1-of-4 subsample of one packed example's
        stored planes, kept in their dtype (the loaders' pick semantics)."""
        from videonavqa_tpu_torch.data.pipeline import subsample_frames

        if self.feature_loader is None:
            raise ValueError('this server decodes videos - POST {"video": "<path>", ...} '
                             'instead of "example"')
        if name not in self.id_to_idx:
            raise ValueError(f"unknown example id {name!r}")
        idx = self.id_to_idx[name]
        with self._decode_lock:
            if idx in self._example_cache:
                self._example_cache.move_to_end(idx)
                raw = self._example_cache[idx]
            else:
                raw = self.feature_loader.example_frames(idx)
                if self._example_cache_size:
                    self._example_cache[idx] = raw
                    while len(self._example_cache) > self._example_cache_size:
                        self._example_cache.popitem(last=False)
        with self._rng_lock:
            return subsample_frames(raw, self.rng, dtype=raw.dtype)

    # --- batches -----------------------------------------------------------------

    def bucket_for(self, v_len):
        """Smallest frame bucket covering ``v_len`` (35 when none does)."""
        return min((t for t in self.frame_buckets if t >= max(v_len, 1)),
                   default=C.MAX_ALLOWED_NUM_FRAMES_DROPPING)

    def _visual_dtype(self, frames):
        if isinstance(frames, torch.Tensor):
            return frames.dtype
        dtype = torch.from_numpy(np.empty(0, frames.dtype)).dtype
        if self.frame_dtype is not None and dtype != self.frame_dtype and \
                dtype.itemsize == self.frame_dtype.itemsize and not dtype.is_floating_point:
            return self.frame_dtype   # the bits of a bf16 / fp8 plane
        return dtype

    def make_batch(self, items):
        """The padded batch of ``items`` on the engine's device.

        items: list of (visual, v_len, tokens); visual is the item's frames
        (features [35, 10, 13, C]: bf16 / fp8, or their bits as numpy; or
        video [35, 160, 208, 3] uint8) and is ignored (pass None) for a
        question-only model. Host arrays are staged into pinned memory and
        copied on a side stream; frames already on the card are gathered
        there."""
        n = len(items)
        if not 1 <= n <= self.B:
            raise ValueError(f"a micro-batch holds 1..{self.B} items, got {n}")
        # under a mesh, host tensors: each device takes its rows (_mesh_forward)
        pin = self.device.type == "cuda" and self.mesh is None
        host = {"question": torch.zeros((self.B, C.MAX_Q_LEN), dtype=torch.int32,
                                        pin_memory=pin),
                "v_len": torch.ones(self.B, dtype=torch.int32, pin_memory=pin),
                "q_len": torch.ones(self.B, dtype=torch.int32, pin_memory=pin)}
        q, vl_np, ql_np = (host[k].numpy() for k in ("question", "v_len", "q_len"))
        for i, (_, vl, tokens) in enumerate(items):
            tokens = np.asarray(tokens, dtype=np.int32)[:C.MAX_Q_LEN]
            q[i, :len(tokens)] = tokens
            vl_np[i] = max(int(vl), 1)
            ql_np[i] = max(len(tokens), 1)
        on_card = []
        if self.visual_key is not None:
            t_b = self.bucket_for(int(vl_np[:n].max()))
            first = items[0][0]
            shape = (self.B, t_b, *first.shape[1:])
            dtype = self._visual_dtype(first)
            if isinstance(first, torch.Tensor) and first.device != torch.device("cpu"):
                visual = torch.zeros(shape, dtype=dtype, device=self.device)
                for i, (frames, _, _) in enumerate(items):
                    t_i = min(frames.shape[0], t_b)
                    visual[i, :t_i] = frames[:t_i].to(self.device)
                on_card.append(visual)
            else:
                visual = torch.zeros(shape, dtype=dtype, pin_memory=pin)
                out = _host_view(visual)
                for i, (frames, _, _) in enumerate(items):
                    if isinstance(frames, torch.Tensor):
                        frames = _host_view(frames)
                    t_i = min(frames.shape[0], t_b)
                    src = frames[:t_i]
                    if src.dtype != out.dtype:
                        src = src.view(out.dtype)
                    out[i, :t_i] = src
                host[self.visual_key] = visual
        batch = self._to_device(host) if self.mesh is None else dict(host)
        if on_card:
            batch[self.visual_key] = on_card[0]
        return batch

    def _to_device(self, host):
        """Host tensors -> the device. On the card each pinned tensor is
        copied with ``non_blocking`` on a side stream; the current stream
        waits on an event recorded after the copies, and each device tensor
        is marked as used on it, so the copies of the next batch overlap this
        batch's forward."""
        if self.device.type != "cuda":
            return dict(host)
        if not hasattr(self, "_copy_stream"):
            self._copy_stream = torch.cuda.Stream(self.device)
        side = self._copy_stream
        current = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(side):
            moved = {k: v.to(self.device, non_blocking=True) for k, v in host.items()}
            copied = torch.cuda.Event()
            copied.record(side)
        current.wait_event(copied)
        for t in moved.values():
            t.record_stream(current)
        return moved

    def features(self, batch, cfg=None):
        """Video mode: f32 stem features [B, T, 10, 13, C] of a padded batch's
        frames: ``stem`` where it is a callable, else the stem's weights in
        ``cfg.compute_dtype`` with block 1 through its kernel where
        ``cfg.use_pallas_kernels`` (``cfg``: the engine's by default)."""
        video = normalize_video(batch["video"])
        stem = self.stem[video.device] if isinstance(self.stem, dict) else self.stem
        if callable(stem):
            return stem(video)
        cfg = cfg or self.cfg
        return stem_features(*stem, video, dtype=DTYPES[cfg.compute_dtype],
                             use_kernel=cfg.use_pallas_kernels)

    def forward(self, batch, cfg=None, generator=None, weights=None):
        """(logits, new_state) of one padded batch under ``cfg`` (the engine's
        by default) on ``weights`` (the current ones by default). In video
        mode a stem model's frames first become features. Without
        ``generator`` the batch draws from one seeded with the engine's seed."""
        cfg = cfg or self.cfg
        weights = weights or self._weights
        if self.mesh is not None:
            return self._mesh_forward(batch, cfg, weights)
        params, state = weights
        if self.stem is not None:
            batch = dict(batch, v_features=self.features(batch, cfg))
            del batch["video"]
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(self.seed)
        return forward(self.spec, cfg, params, state, batch, generator)

    def _mesh_forward(self, batch, cfg, weights):
        """(logits [B, K] on the first device, [each rank's new state]): each
        rank's forward on its rows, in its thread; a draw at eval is the
        global batch's (``collectives.batch_rows``), from a generator seeded
        with the engine's seed."""
        ranks = self.mesh.ranks
        out = [None] * len(ranks)

        def run(i):
            rank = ranks[i]
            params, state = weights[i]
            with collectives.thread_rank(rank), torch.inference_mode():
                local = shard_batch(batch, rank)
                if self.stem is not None:
                    local = dict(local, v_features=self.features(local, cfg))
                    del local["video"]
                gen = torch.Generator(device=rank.device).manual_seed(self.seed)
                out[i] = forward(self.spec, cfg, params, state, local, gen)

        with self._mesh_lock:
            futures = [self._pool.submit(run, i) for i in range(len(ranks))]
            done, _ = wait(futures, return_when=FIRST_EXCEPTION)
            if any(f.exception() for f in done):   # release the members still waiting
                for g in self.mesh.thread_groups:
                    g.abort()
            wait(futures)
            errors = [f.exception() for f in futures if f.exception() is not None]
            if errors:
                for g in self.mesh.thread_groups:
                    g.reset()
                first = [e for e in errors if not isinstance(e, threading.BrokenBarrierError)]
                raise (first or errors)[0]
        logits = torch.cat([out[i][0].to(self.device) for i, r in enumerate(ranks)
                            if r.model_index == 0])
        return logits, [o[1] for o in out]

    def _forward_calibrate(self, batch, weights):
        """The f32 calibration forward -> (logits, state with the int8 scales)."""
        return self.forward(batch, self._calibrate_cfg, weights=weights)

    def dispatch_batch(self, items):
        """Stage, copy and enqueue one micro-batch's forward without waiting
        for it -> a handle for ``fetch``: ``(probs, n, ready)``, where
        ``ready`` is a CUDA event recorded after the probabilities' copy to
        pinned host memory (None where ``probs`` is already on the host). An
        int8 calibration batch runs to its end here: its state commits under
        the weights lock, and only if no reload swapped the weights
        meanwhile (else the flag stays set and the next batch calibrates the
        new weights)."""
        n = len(items)
        batch = self.make_batch(items)
        with self._weights_lock:
            weights = self._weights
            version = self._weights_version
            calibrate = self._needs_int8_calibration
        with torch.inference_mode():
            if calibrate:
                logits, new_state = self._forward_calibrate(batch, weights)
                probs = torch.softmax(logits, dim=-1)[:n].cpu().numpy()
                with self._weights_lock:
                    if self._weights_version == version:
                        self._weights = (weights[0], new_state) if self.mesh is None else \
                            tuple((w[0], st) for w, st in zip(weights, new_state))
                        self._needs_int8_calibration = False
                return probs, n, None
            logits, _ = self.forward(batch, weights=weights)
            probs = torch.softmax(logits, dim=-1)[:n]
            if self.device.type != "cuda":
                return probs.numpy(), n, None
            out = torch.empty(probs.shape, dtype=probs.dtype, pin_memory=True)
            out.copy_(probs, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        return out, n, ready

    @staticmethod
    def fetch(handle):
        """The [n, num_classes] f32 probabilities of a ``dispatch_batch``
        handle, once the card has computed them."""
        probs, _, ready = handle
        if ready is None:
            return probs
        ready.synchronize()
        return probs.numpy()

    def run_batch(self, items):
        """[n, num_classes] f32 probabilities of ``items`` (padding rows dropped)."""
        return self.fetch(self.dispatch_batch(items))

    def warmup(self):
        """Build the kernels (nvcc at first use) and run every serving shape
        (one per frame bucket, or the one 35-frame shape) before traffic.

        With the int8 trunk the calibration runs first. In feature-cache mode
        it calibrates on a stored example. In video mode there are no
        representative pixels at hand: the zero frames of the warm-up are a
        black video, whose scales would clip real traffic's activations, so
        video mode calibrates provisionally on random pixels at every bucket
        and then re-arms, and the first real micro-batch calibrates anew."""
        lengths = list(self.frame_buckets) or [C.MAX_ALLOWED_NUM_FRAMES_DROPPING]
        shape = (C.MAX_ALLOWED_NUM_FRAMES_DROPPING, *(self.frame_shape or ()))
        np_dtype = np.uint8 if self.frame_dtype is None else \
            _host_view(torch.empty(0, dtype=self.frame_dtype)).dtype
        video_int8_cal = self._needs_int8_calibration and self.feature_loader is None
        if self._needs_int8_calibration and self.feature_loader is not None:
            frames, vl = self.load_example(min(self.id_to_idx))
            self.run_batch([(frames, vl, [1])])
        elif video_int8_cal:
            rnd = self.rng.randint(0, 256, size=shape).astype(np_dtype)
            for t in lengths:
                with self._weights_lock:
                    self._needs_int8_calibration = True
                self.run_batch([(rnd, t, [1])])
        frames = np.zeros(shape, np_dtype)
        for t in lengths:
            self.run_batch([(frames, t, [1])])
        if video_int8_cal:
            with self._weights_lock:
                self._needs_int8_calibration = True
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

