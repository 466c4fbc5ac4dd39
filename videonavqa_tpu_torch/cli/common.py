"""The training harness shared by the entry points (the counterpart of the JAX
package's cli/common.py): the flags, the frozen stem's weights, the batch
feed, the epoch loop, ``run_training`` and ``run_test``.

It keeps the JAX harness's behaviour:

- an epoch loop that prints the running loss every ``--stats_after_every``
  iterations, fetching each step's metrics one step late so the host does
  not wait on the device every step;
- epoch summaries in the same lines (the loss normalized by the example
  count, hits, weighted and micro F1) and the per-class accuracy dict after
  validation;
- epoch checkpoints (``e{N}_``) in the JAX package's format, with Adam's
  state and the train F1 in the metadata, written in the background;
  ``--checkpoint_path`` also reads a reference ``torch.save`` checkpoint
  (``utils/checkpoint.py load_any_checkpoint``; Adam then starts afresh);
- MAC's elementwise gradient clamp and its epoch-1 lr/10 dip;
- the same JSONL events (``utils/logging.py``);
- ``--feature_cache``: the frozen stem's features extracted once into
  ``features_{split}[_fp8].fnr`` (``cli/extract_features.py``; the stem loads
  only when a cache is missing or stale, and is dropped afterwards), then
  training and validation from those files through the native loader;
- ``--int8_trunk``: the FiLM trunk's dynamic int8 convs in the eval step;
- ``--int8_stem``: the frozen stem in int8 (``stem/quant.py``), calibrated
  (``--int8_stem_calibration``) on the first batch of the train loader's
  epoch 0 (``run_training``) or of the test loader (``run_test``);
- the test split (``run_test``): deterministic frame picks, a checkpoint
  required, the final partial batch padded and counted on its real rows, the
  per-class accuracies and F1 under "Testing", and the ``t_``/``p_``/``q_``
  dumps of targets, predictions and question types beside the checkpoint
  (``cli/results_analysis.py`` reads them).

Every zoo model runs. Flags the port does not run yet (multi-GPU) stop the
run with a ``SystemExit`` that names the ROADMAP item, whenever they are set
away from their defaults. Entry points run on the card
(``--device cuda``, the default) unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import pprint as pp
import time

import numpy as np
import torch

from videonavqa_tpu_torch.data import BatchLoader, DataPaths, VNQADataset, load_json
from videonavqa_tpu_torch.data.prefetch import device_prefetch, host_prefetch
from videonavqa_tpu_torch.models import MODEL_REGISTRY, ModelConfig, get_model
from videonavqa_tpu_torch.models.base import DTYPES
from videonavqa_tpu_torch.train import metrics as M
from videonavqa_tpu_torch.train.step import (
    make_eval_step, make_optimizer, make_train_step, set_learning_rate,
)
from videonavqa_tpu_torch.utils import checkpoint as ckpt
from videonavqa_tpu_torch.utils import constants as C
from videonavqa_tpu_torch.utils.device import resolve_device, tree_to
from videonavqa_tpu_torch.utils.logging import MetricsLogger, maybe_profile

# make_train_step's options for each model the port trains, as the harness
# sets them (Harness, run_training) at the preset's --loss_reduction: every
# q_and_v model and the video-only harness clip the global norm at 1.0, and
# MAC clamps each gradient element to +-1 first; the question-only harness
# clips nothing. eval.sh's presets (film_gp_pt, film_attn_pt, time_multi_hop)
# sum the loss; the others run at their parser's default, the mean. The question-only harness also turns class
# weights on by default (--use_class_weights); they come from the training
# set's label counts, so the caller passes them, not these options.
TRAIN_STEP_OPTIONS = {
    "film_gp_pt": dict(reduction="sum", clip_value=1.0),
    "film_attn_pt": dict(reduction="sum", clip_value=1.0),
    "time_multi_hop": dict(reduction="sum", clip_value=1.0),
    "mac": dict(reduction="mean", clip_value=1.0, elementwise_clamp=1.0),
    "v_only_cnn2d_lstm": dict(reduction="mean", clip_value=1.0),
    "concat2d": dict(reduction="mean", clip_value=1.0),
    "v_only_cnn3d": dict(reduction="mean", clip_value=1.0),
    "concat3d": dict(reduction="mean", clip_value=1.0),
    "lstm": dict(reduction="mean"),
    "bow": dict(reduction="mean"),
}
# The presets' learning rates (eval.sh; the others: their parser's default,
# build_q_and_v_parser's for MAC and the concat models, v_only_eval's and
# q_only_eval's).
PRESET_L_RATE = {"film_gp_pt": 1e-4, "film_attn_pt": 1e-4, "time_multi_hop": 5e-5, "mac": 1e-4,
                 "v_only_cnn2d_lstm": 1e-4, "concat2d": 1e-4, "v_only_cnn3d": 1e-4,
                 "concat3d": 1e-4, "lstm": 1e-5, "bow": 1e-5}


def mac_lr_for_epoch(l_rate: float, epoch: int) -> float:
    """The reference MAC schedule: its "warmup" lr/10 is assigned after epoch
    0 has trained, so epoch 0 trains at the full lr, epoch 1 at lr/10, and
    every later epoch at the full lr again."""
    return l_rate / 10.0 if epoch == 1 else l_rate


def _true(s):
    return s.lower() == "true"


def add_common_args(parser: argparse.ArgumentParser):
    """The JAX harness's common flags, with its defaults, and ``--device``."""
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (the default) or 'cpu'; there is no fallback "
                             "to the CPU when no card is present")
    parser.add_argument("--data_dir", type=str, default="../data/", help="dataset root")
    parser.add_argument("--num_classes", type=int, default=C.NUM_CLASSES)
    parser.add_argument("--vocab_size", type=int, default=C.VOCAB_SIZE)
    parser.add_argument("--checkpoint_path", type=str)
    parser.add_argument("--num_workers", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--compute_dtype", type=str, default="bfloat16",
                        choices=["bfloat16", "float32"])
    parser.add_argument("--metrics_file", type=str, default=None,
                        help="JSONL metrics stream")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace of the first training epoch here")
    parser.add_argument("--jax_cache_dir", type=str, default=None,
                        help="refused: the port compiles no XLA programs")
    parser.add_argument("--stochastic_eval", type=_true, default=False,
                        help="draw the frame subsampling anew at val/test time, as the "
                             "reference does (nondeterministic metrics)")
    parser.add_argument("--mesh_devices", type=int, default=0,
                        help="refused unless 0: multi-GPU is not ported yet (ROADMAP: multi-GPU)")
    parser.add_argument("--model_parallel", type=int, default=1,
                        help="refused unless 1 (ROADMAP: multi-GPU)")
    parser.add_argument("--distributed", type=_true, default=False,
                        help="refused unless false (ROADMAP: multi-GPU)")
    parser.add_argument("--coordinator_address", type=str, default=None)
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    return parser


def build_q_and_v_parser():
    """The flags of the question + video harness."""
    parser = argparse.ArgumentParser()
    add_common_args(parser)
    parser.add_argument("--model", type=str,
                        choices=["concat2d", "concat3d", "film_gp_pt", "film_attn_pt",
                                 "mac", "time_multi_hop"])
    parser.add_argument("--q_encoder", type=str, choices=["lstm", "bow"], default="lstm")
    parser.add_argument("--use_obj_detector", type=lambda s: s.lower() != "false", default=True)
    parser.add_argument("--use_visual_features", type=lambda s: s.lower() != "false",
                        default=True)
    parser.add_argument("--embed_size", type=int, default=128)
    parser.add_argument("--hidden_size", type=int, default=128)
    parser.add_argument("--at_hidden_size", type=int, default=128)
    parser.add_argument("--num_res_blocks", type=int, default=1)
    parser.add_argument("--num_res_block_channels", type=int, default=512)
    parser.add_argument("--num_input_channels", type=int, default=512)
    parser.add_argument("--num_tail_channels", type=int, default=16)
    parser.add_argument("--mac_dim", type=int, default=512)
    parser.add_argument("--mac_max_step", type=int, default=12)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--clip_value", type=float, default=1.0)
    parser.add_argument("--l_rate", type=float, default=1e-4)
    parser.add_argument("--loss_reduction", type=str, default="mean",
                        choices=["sum", "mean", "elementwise_mean"])
    parser.add_argument("--num_epochs", type=int, default=1)
    parser.add_argument("--use_class_weights", type=_true, default=False)
    parser.add_argument("--frcnn_pretrained_path", type=str)
    parser.add_argument("--stats_after_every", type=int, default=400)
    parser.add_argument("--val_only", type=_true, default=False)
    parser.add_argument("--bucket_frames",
                        type=lambda s: "auto" if s.lower() == "auto" else s.lower() == "true",
                        default=False,
                        help="group videos of like length per batch and trim the frame "
                             "axis to bucket sizes; 'auto' picks the cost-optimal bucket "
                             "edges for this dataset's lengths (data/buckets.py)")
    parser.add_argument("--use_vnr", type=_true, default=False,
                        help="feed batches through the native VNR loader ({split}.vnr, "
                             "packed at first use; see cli.pack_dataset)")
    parser.add_argument("--int8_stem", type=_true, default=False,
                        help="run the frozen stem in int8, calibrated on the first batch "
                             "(stem/quant.py); validate accuracy before paper-comparable runs")
    parser.add_argument("--int8_stem_calibration", type=str, default="improved",
                        choices=["absmax", "improved"],
                        help="int8 stem calibration: 'improved' adds per-input-channel "
                             "equalization, a 99.99th-percentile clip and bias correction "
                             "(calibrate_stem_quant); 'absmax' is each conv input's absmax "
                             "x 1.1 (calibrate_act_scales)")
    parser.add_argument("--feature_cache", type=_true, default=False,
                        help="train and validate from the frozen stem's features, extracted "
                             "once into features_{split}.fnr (cli.extract_features)")
    parser.add_argument("--feature_dtype", type=str, default="bfloat16",
                        choices=["bfloat16", "float8_e4m3"],
                        help="the feature cache's dtype; fp8 halves its bytes")
    parser.add_argument("--use_pallas_kernels", type=_true, default=None,
                        help="run the eval steps through the hand-written CUDA kernels "
                             "(film re-encode, attention tail, masked LSTM); training "
                             "steps run the plain versions")
    parser.add_argument("--int8_trunk", type=_true, default=False,
                        help="the FiLM trunk's convs in dynamic int8 in the eval step "
                             "(training steps run them in --compute_dtype)")
    return parser


# (flag, its default, the ROADMAP item that ports it, by its title)
_REFUSED = (
    ("mesh_devices", 0, "multi-GPU"),
    ("model_parallel", 1, "multi-GPU"),
    ("distributed", False, "multi-GPU"),
    ("coordinator_address", None, "multi-GPU"),
    ("num_processes", None, "multi-GPU"),
    ("process_id", None, "multi-GPU"),
)


def refuse_unported(args, model_name):
    """SystemExit for a model the port does not know or a flag value it does
    not run yet."""
    if model_name not in MODEL_REGISTRY:
        raise SystemExit(f"--model {model_name}: unknown; the port trains "
                         f"{sorted(MODEL_REGISTRY)}")
    for flag, default, item in _REFUSED:
        value = getattr(args, flag, default)
        if value != default:
            raise SystemExit(f"--{flag} {value}: not ported yet (ROADMAP: {item}); "
                             f"leave it at its default, {default}")
    if getattr(args, "jax_cache_dir", None):
        raise SystemExit("--jax_cache_dir: the port compiles no XLA programs; drop the flag")


def cfg_from_args(args, model_name):
    return ModelConfig(
        model=model_name,
        num_classes=args.num_classes,
        vocab_size=args.vocab_size,
        q_encoder=getattr(args, "q_encoder", "lstm"),
        embed_size=getattr(args, "embed_size", 128),
        hidden_size=getattr(args, "hidden_size", 128),
        at_hidden_size=getattr(args, "at_hidden_size", 128),
        num_res_blocks=getattr(args, "num_res_blocks", 1),
        num_res_block_channels=getattr(args, "num_res_block_channels", 512),
        num_input_channels=getattr(args, "num_input_channels", 512),
        num_tail_channels=getattr(args, "num_tail_channels", 16),
        mac_dim=getattr(args, "mac_dim", 512),
        mac_max_step=getattr(args, "mac_max_step", 12),
        compute_dtype=args.compute_dtype,
        use_pallas_kernels=bool(getattr(args, "use_pallas_kernels", None)),
        use_int8_trunk=bool(getattr(args, "int8_trunk", False)),
    )


def load_stem(args, paths: DataPaths, device, calibration_video=None):
    """The frozen stem as ``stem_fn(video /255) -> features``: VGG-16 from
    ``--frcnn_pretrained_path`` and the detector from the dataset's
    ``obj_detect.pt`` where those files exist, else the reference init from
    a generator seeded 1234.

    With ``--int8_stem true`` and a calibration batch (``calibration_video``,
    [B, T, 160, 208, 3] f32, pixels /255) the stem is the int8 one, calibrated
    on that batch by ``--int8_stem_calibration``; VGG block 1 is quantized
    with the rest, so no kernel runs in it. Otherwise it runs in
    ``--compute_dtype``, and on the card VGG block 1 runs through the
    ``vgg_block1`` kernel."""
    from videonavqa_tpu_torch.stem import (
        STEM_SEED, init_obj_detector, init_vgg_partial, stem_features)
    from videonavqa_tpu_torch.utils import torch_import as ti

    gen = torch.Generator().manual_seed(STEM_SEED)
    frcnn_path = getattr(args, "frcnn_pretrained_path", None)
    if frcnn_path and os.path.exists(frcnn_path):
        vgg_params = ti.import_vgg_partial(ti.load_torch_state_dict(frcnn_path, key=None))
    else:
        print("=> No VGG-16 weights found - using random frozen stem")
        vgg_params = init_vgg_partial(gen)
    if os.path.exists(paths.obj_detector_file):
        det_params, det_state = ti.import_obj_detector(
            ti.load_torch_state_dict(paths.obj_detector_file))
    else:
        print("=> No obj_detect.pt found - using random object detector")
        det_params, det_state = init_obj_detector(gen)
    vgg, det_p, det_s = (tree_to(t, device) for t in (vgg_params, det_params, det_state))

    if getattr(args, "int8_stem", False) and calibration_video is not None:
        from videonavqa_tpu_torch.stem import quant

        mode = getattr(args, "int8_stem_calibration", "improved")
        print(f"=> Calibrating int8 stem on one batch ({mode})")
        calib = calibration_video.to(device=device, dtype=torch.float32)
        calibrate = quant.calibrate_stem_quant if mode == "improved" else \
            quant.calibrate_act_scales
        qstem = quant.quantize_stem(vgg, det_p, act_scales=calibrate(vgg, det_p, det_s, calib))
        del calib

        def stem_fn(video):
            return quant.stem_features_int8(qstem, det_p, det_s, video)

        return stem_fn

    dtype = DTYPES[args.compute_dtype]
    use_kernel = device.type == "cuda"

    def stem_fn(video):
        return stem_features(vgg, det_p, det_s, video, dtype=dtype, use_kernel=use_kernel)

    return stem_fn


def calibration_batch(loader):
    """The first batch of ``loader``'s epoch 0 as an int8-stem calibration
    video: f32 [B, T, 160, 208, 3] pixels /255 (the JAX harness's). The
    epoch's generator is closed at once, so the loader's workers for it end;
    the run's epoch 0 starts again from the same batch."""
    epoch = loader.epoch(0)
    try:
        first = next(iter(epoch))
    finally:
        close = getattr(epoch, "close", None)
        if close is not None:
            close()
    return torch.from_numpy(np.ascontiguousarray(first["video"])).float() / 255.0


# cached features arrive as the bits of their dtype (data/vnr.py)
_FEATURE_BITS = {np.dtype(np.uint16): torch.bfloat16, np.dtype(np.uint8): torch.float8_e4m3fn}


def prepare_batch(batch):
    """A numpy batch -> (dict of CPU tensors, num_valid): ``q_id`` dropped,
    a ``valid`` mask added where the batch holds padding rows; videos stay
    uint8 (the /255 runs on the device), cached features' bits are viewed as
    bf16 or fp8 e4m3 (fp8 is widened in the forward)."""
    num_valid = int(batch.pop("num_valid"))
    out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items() if k != "q_id"}
    feats = batch.get("v_features")
    if feats is not None and feats.dtype in _FEATURE_BITS:
        out["v_features"] = out["v_features"].view(_FEATURE_BITS[feats.dtype])
    B = out["label"].shape[0]
    if num_valid < B:
        out["valid"] = torch.arange(B) < num_valid
    return out, num_valid


def batch_seed(seed, epoch, index, train):
    """The seed of one batch's generator: from ``seed`` (the harness passes
    --seed + 1), the epoch, the batch's index and the phase, as the JAX
    harness splits its key once a batch."""
    words = [seed & 0xFFFFFFFFFFFFFFFF, epoch, index, int(train)]
    return int(np.random.SeedSequence(words).generate_state(1)[0])


class Harness:
    """A run's set-up: the refusals, the device, the dataset's splits, the
    model's spec and config, the frozen stem, the metrics stream and the
    generator that every batch reseeds."""

    def __init__(self, args, model_name, *, q_only=False, v_only=False):
        refuse_unported(args, model_name)
        self.device = resolve_device(args.device)
        self.args = args
        self.paths = DataPaths(args.data_dir)
        self.spec = get_model(model_name)
        self.cfg = cfg_from_args(args, model_name)
        self.q_only, self.v_only = q_only, v_only
        self.elementwise_clamp = 1.0 if model_name == "mac" else None
        self.split = load_json(self.paths.split_file)
        self.labels = load_json(self.paths.labels_file)

        self.needs_stem = self.spec.uses_stem and getattr(args, "use_visual_features", True)
        # --feature_cache never runs the stem in a step; extraction loads its
        # own stem where a cache file is missing or stale. The int8 stem is
        # built once a calibration batch is at hand (run_training, run_test).
        cached = getattr(args, "feature_cache", False) and not q_only
        int8 = getattr(args, "int8_stem", False)
        self.stem_fn = load_stem(args, self.paths, self.device) \
            if self.needs_stem and not cached and not int8 else None
        self.class_weights = None
        self.reduction = getattr(args, "loss_reduction", "mean") or "mean"
        # every batch reseeds it (batch_seed); the eval step draws from it too
        self.generator = torch.Generator(device=self.device)
        self.metrics = MetricsLogger(
            getattr(args, "metrics_file", None),
            run_meta={"model": model_name, "args": vars(args)})

    def dataset(self, part, *, q_metadata=False, deterministic=False):
        if getattr(self.args, "stochastic_eval", False):
            deterministic = False
        return VNQADataset(
            self.paths, self.split[part], self.labels, q_only=self.q_only,
            v_only=self.v_only, q_metadata=q_metadata,
            deterministic=deterministic, seed=self.args.seed)

    def init_model(self):
        return self.spec.init(torch.Generator().manual_seed(self.args.seed), self.cfg,
                              self.device)

    def make_steps(self, optimizer, *, reduction=None, clip_value=None):
        """(train step, eval step) with the harness's class weights, stem and
        MAC's clamp."""
        weights = None if self.class_weights is None else \
            torch.as_tensor(self.class_weights, device=self.device)
        reduction = reduction or self.reduction
        train_step = make_train_step(
            self.spec, self.cfg, optimizer, class_weights=weights, reduction=reduction,
            clip_value=clip_value, elementwise_clamp=self.elementwise_clamp,
            stem_fn=self.stem_fn)
        eval_step = make_eval_step(self.spec, self.cfg, self.generator, class_weights=weights,
                                   reduction=reduction, stem_fn=self.stem_fn)
        return train_step, eval_step

    def run_epoch(self, step_fn, params, state, loader, epoch, *, train):
        """One pass over ``loader`` -> (state, summary). A train step updates
        ``params`` in place; each batch's generator is seeded by
        ``batch_seed``."""
        t0 = time.time()
        total_loss, hit, num_examples = 0.0, 0, 0
        y_pred, y_target = [], []

        def prepare(np_batch):
            labels_np = np_batch["label"]
            batch, num_valid = prepare_batch(np_batch)
            return batch, num_valid, labels_np

        pending = None  # metrics fetched one step late, so the device runs ahead

        def drain(pending):
            nonlocal total_loss, hit, num_examples
            metrics, num_valid, labels_np = pending
            preds = metrics["preds"][:num_valid].cpu().numpy()
            total_loss += float(metrics["loss"])
            hit += int(np.sum(preds == labels_np[:num_valid]))
            num_examples += num_valid
            y_pred.append(preds)
            y_target.append(labels_np[:num_valid])

        batches = device_prefetch(host_prefetch(loader.epoch(epoch)), prepare, self.device)
        for i, (batch, num_valid, labels_np) in enumerate(batches):
            self.generator.manual_seed(batch_seed(self.args.seed + 1, epoch, i, train))
            if train:
                state, metrics = step_fn(params, state, batch, self.generator)
            else:
                metrics = step_fn(params, state, batch)
            if pending is not None:
                drain(pending)
            pending = (metrics, num_valid, labels_np)
            if train and (i + 1) % self.args.stats_after_every == 0:
                denom = max(num_examples, 1)
                print("Average loss after %d iterations in epoch %d: %.6f"
                      % (i + 1, epoch + 1, total_loss / denom))
                self.metrics.log("train_progress", epoch=epoch, iteration=i + 1,
                                 avg_loss=total_loss / denom)
        if pending is not None:
            drain(pending)

        y_pred = np.concatenate(y_pred) if y_pred else np.array([])
        y_target = np.concatenate(y_target) if y_target else np.array([])
        f1_w = M.f1_score(y_target, y_pred, average="weighted")
        f1_micro = M.f1_score(y_target, y_pred, average="micro")
        summary = {
            "loss": total_loss / max(num_examples, 1), "hit": hit,
            "num_examples": num_examples, "f1_w": f1_w, "f1_micro": f1_micro,
            "y_pred": y_pred, "y_target": y_target,
            "examples_per_sec": num_examples / max(time.time() - t0, 1e-9),
        }
        self.metrics.log("train_epoch" if train else "eval_epoch", epoch=epoch,
                         loss=summary["loss"], accuracy=hit / max(num_examples, 1),
                         f1_w=f1_w, f1_micro=f1_micro,
                         examples_per_sec=summary["examples_per_sec"])
        return state, summary

    def print_val_summary(self, summary, *, header="Validation"):
        accs = M.per_class_accuracies(
            summary["y_target"], summary["y_pred"], self.cfg.num_classes)
        pp.pprint({i: accs[i] for i in np.nonzero(accs)[0].tolist()})
        print("{}:\tAverage loss: {:.6f}, Accuracy: {}/{}, F1: w{:.4f}, micro{:.4f}\n".format(
            header, summary["loss"], summary["hit"], summary["num_examples"],
            summary["f1_w"], summary["f1_micro"]))


def _vnr_loaders(args, h, vnr_kw):
    """The train and val .vnr loaders, each split packed at first use."""
    from videonavqa_tpu_torch.data.vnr import VNRBatchLoader, ensure_built, pack_dataset

    ensure_built()
    loaders = {}
    for part, det in (("train", False), ("val", not args.stochastic_eval)):
        path = os.path.join(args.data_dir, f"{part}.vnr")
        if not os.path.exists(path):
            print(f"=> Packing {part} split into {path}")
            pack_dataset(args.data_dir, path, h.split[part])
        loaders[part] = VNRBatchLoader(path, args.batch_size, shuffle=(part == "train"),
                                       mode=part, deterministic=det, **vnr_kw)
    return loaders["train"], loaders["val"]


def _extract_features_once(args, h, splits):
    """{split: feature-cache file}, extracted where missing or stale; the stem
    loads only then, and is dropped afterwards."""
    from videonavqa_tpu_torch.cli.extract_features import ensure_features, features_needed

    missing = features_needed(args, h.paths, splits, quiet=True)
    stem_fn = load_stem(args, h.paths, h.device) if missing else None
    files = ensure_features(args, stem_fn, splits, h.split)
    del stem_fn
    if h.device.type == "cuda":
        torch.cuda.empty_cache()
    return files


def run_training(args, model_name, *, q_only=False, v_only=False, clip_value=None):
    if getattr(args, "feature_cache", False) and getattr(args, "int8_stem", False):
        raise SystemExit("--feature_cache and --int8_stem are mutually exclusive (the cache is "
                         "extracted with the bf16 stem)")
    h = Harness(args, model_name, q_only=q_only, v_only=v_only)
    train_ds = h.dataset("train")
    val_ds = h.dataset("val", deterministic=True)
    print("%d train examples, %d validation examples" % (len(train_ds), len(val_ds)))

    if getattr(args, "use_class_weights", False):
        h.class_weights = train_ds.get_class_weights(h.cfg.num_classes)
        print("Using class weights", h.class_weights)

    bucket = getattr(args, "bucket_frames", False) and not q_only
    # the loaders' frame_buckets: "auto" = the dataset's optimal DP edges
    fb_spec = "auto" if bucket == "auto" else (True if bucket else None)
    bucket = bool(bucket)
    if getattr(args, "feature_cache", False) and h.needs_stem and not q_only:
        from videonavqa_tpu_torch.data.vnr import VNRBatchLoader

        files = _extract_features_once(args, h, ("train", "val"))
        h.needs_stem = False
        vnr_kw = dict(seed=args.seed, bucket_by_length=bucket, frame_buckets=fb_spec)
        train_loader = VNRBatchLoader(files["train"], args.batch_size, shuffle=True,
                                      mode="train", **vnr_kw)
        val_loader = VNRBatchLoader(files["val"], args.batch_size, shuffle=False, mode="val",
                                    deterministic=not args.stochastic_eval, **vnr_kw)
    elif getattr(args, "use_vnr", False) and not q_only:
        train_loader, val_loader = _vnr_loaders(
            args, h, dict(seed=args.seed, bucket_by_length=bucket, frame_buckets=fb_spec))
    else:
        loader_kw = dict(num_workers=args.num_workers, seed=args.seed,
                         bucket_by_length=bucket, frame_buckets=fb_spec)
        train_loader = BatchLoader(train_ds, args.batch_size, shuffle=True, **loader_kw)
        val_loader = BatchLoader(val_ds, args.batch_size, shuffle=False, mode="val",
                                 **loader_kw)

    if h.needs_stem and h.stem_fn is None:   # int8: calibrate on one batch
        h.stem_fn = load_stem(args, h.paths, h.device,
                              calibration_video=calibration_batch(train_loader))

    params, state = h.init_model()
    optimizer = make_optimizer(params, args.l_rate)

    start_epoch = 0
    if args.checkpoint_path and os.path.exists(args.checkpoint_path):
        print("=> Restoring from checkpoint path %s" % args.checkpoint_path)
        # the learning rate too: a restored optimizer keeps the checkpoint's
        meta = ckpt.load_any_checkpoint(args.checkpoint_path, model_name=model_name, cfg=h.cfg,
                                        params=params, state=state, optimizer=optimizer)
        start_epoch = int(meta.get("epoch", -1)) + 1
        print("==> Restored checkpoint %s (epoch %d)" % (args.checkpoint_path, start_epoch))
    elif args.checkpoint_path:
        print("=> No checkpoint existent - will save the model here")

    train_step, eval_step = h.make_steps(optimizer, clip_value=clip_value)
    for epoch in range(start_epoch, start_epoch + args.num_epochs):
        if model_name == "mac":
            lr = mac_lr_for_epoch(args.l_rate, epoch)
            set_learning_rate(optimizer, lr)
            print("learning rate %.5f" % lr)
        if not getattr(args, "val_only", False):
            profile_dir = getattr(args, "profile_dir", None) if epoch == start_epoch else None
            with maybe_profile(profile_dir):
                state, summary = h.run_epoch(train_step, params, state, train_loader, epoch,
                                             train=True)
            print("Train Epoch: {}\tAverage loss: {:.6f}\tAccuracy: {}/{}\t"
                  "F1: w{:.4f}, micro{:.4f}\t({:.2f} ex/s)\n".format(
                      epoch, summary["loss"], summary["hit"], summary["num_examples"],
                      summary["f1_w"], summary["f1_micro"], summary["examples_per_sec"]))
            if args.checkpoint_path:
                ckpt.save_checkpoint_async(
                    ckpt.epoch_path(args.checkpoint_path, epoch),
                    params=params, state=state, optimizer=optimizer,
                    meta={"epoch": epoch, "model": model_name,
                          "train_f1w": summary["f1_w"], "train_f1micro": summary["f1_micro"]})
        _, val_summary = h.run_epoch(eval_step, params, state, val_loader, epoch, train=False)
        h.print_val_summary(val_summary)
    ckpt.wait_for_pending_saves()
    h.metrics.close()
    return params, state


def _test_loader(args, h, q_only):
    """The test split's loader, in order and unbucketed, as the JAX harness
    reads it: the feature cache's (extracted where missing or stale), the
    packed ``test.vnr`` (packed at first use), or the Python loader."""
    from videonavqa_tpu_torch.data.vnr import VNRBatchLoader, ensure_built, pack_dataset

    vnr_kw = dict(shuffle=False, mode="test", deterministic=not args.stochastic_eval,
                  seed=args.seed)
    if getattr(args, "feature_cache", False) and h.needs_stem and not q_only:
        files = _extract_features_once(args, h, ("test",))
        h.needs_stem, h.stem_fn = False, None
        return VNRBatchLoader(files["test"], args.batch_size, **vnr_kw)
    if getattr(args, "use_vnr", False) and not q_only:
        ensure_built()
        path = os.path.join(args.data_dir, "test.vnr")
        if not os.path.exists(path):
            print(f"=> Packing test split into {path}")
            pack_dataset(args.data_dir, path, h.split["test"])
        return VNRBatchLoader(path, args.batch_size, **vnr_kw)
    test_ds = h.dataset("test", q_metadata=True, deterministic=True)
    return BatchLoader(test_ds, args.batch_size, shuffle=False, mode="test",
                       num_workers=args.num_workers, seed=args.seed)


def run_test(args, model_name, *, q_only=False, v_only=False):
    """Test-split inference from a required checkpoint -> the summary; prints
    the per-class accuracies and the "Testing" line, and writes the targets,
    predictions and question types of the real rows as ``t_``, ``p_`` and
    ``q_<checkpoint name>.npy`` beside the checkpoint. Each batch's generator
    is seeded from ``--seed`` + 2 and the batch's index."""
    if getattr(args, "feature_cache", False) and getattr(args, "int8_stem", False):
        raise SystemExit("--feature_cache and --int8_stem are mutually exclusive (the cache is "
                         "extracted with the bf16 stem)")
    h = Harness(args, model_name, q_only=q_only, v_only=v_only)
    print("%d test examples" % len(h.split["test"]))
    loader = _test_loader(args, h, q_only)
    params, state = h.init_model()
    if not args.checkpoint_path or not os.path.exists(args.checkpoint_path):
        raise SystemExit("=> Checkpoint required for testing (--checkpoint_path)")
    meta = ckpt.load_any_checkpoint(args.checkpoint_path, model_name=model_name, cfg=h.cfg,
                                    params=params, state=state)
    if "val_acc" in meta:
        print("=> Restored checkpoint with val acc %s" % meta["val_acc"])
    if h.needs_stem and h.stem_fn is None:   # int8: calibrate on one batch
        h.stem_fn = load_stem(args, h.paths, h.device,
                              calibration_video=calibration_batch(loader))
    eval_step = make_eval_step(h.spec, h.cfg, h.generator, reduction=h.reduction,
                               stem_fn=h.stem_fn)

    y_pred, y_target, qs = [], [], []
    total_loss, hit, num_examples = 0.0, 0, 0
    for i, np_batch in enumerate(loader.epoch(0)):
        labels_np, q_id = np_batch["label"], np_batch.get("q_id")
        batch, num_valid = prepare_batch(np_batch)
        h.generator.manual_seed(batch_seed(args.seed + 2, 0, i, False))
        metrics = eval_step(params, state, tree_to(batch, h.device))
        # int32, as the JAX harness's argmax gives them (the dumps' dtype)
        preds = metrics["preds"][:num_valid].cpu().numpy().astype(np.int32)
        total_loss += float(metrics["loss"])
        hit += int(np.sum(preds == labels_np[:num_valid]))
        # the real rows only; the loss's numerator leaves the padding out too
        num_examples += num_valid
        y_pred.append(preds)
        y_target.append(labels_np[:num_valid])
        if q_id is not None:
            qs.append(q_id[:num_valid])

    y_pred = np.concatenate(y_pred) if y_pred else np.array([], np.int64)
    y_target = np.concatenate(y_target) if y_target else np.array([], np.int64)
    qs = np.concatenate(qs) if qs else np.array([])
    summary = {"loss": total_loss / max(num_examples, 1), "hit": hit,
               "num_examples": num_examples,
               "f1_w": M.f1_score(y_target, y_pred, average="weighted"),
               "f1_micro": M.f1_score(y_target, y_pred, average="micro"),
               "y_pred": y_pred, "y_target": y_target}
    h.print_val_summary(summary, header="Testing")

    base = os.path.basename(args.checkpoint_path)
    out_dir = os.path.dirname(args.checkpoint_path) or "."
    np.save(os.path.join(out_dir, "t_" + base), y_target)
    np.save(os.path.join(out_dir, "p_" + base), y_pred)
    np.save(os.path.join(out_dir, "q_" + base), qs)
    h.metrics.close()
    return summary
