"""Single-example inference: a video file and a question -> the answer (the
port of the JAX package's cli/predict.py).

Loads a checkpoint (and, for a stem model, the frozen stem), tokenizes the
question against the dataset's ``vocab.json``, decodes the video and picks
its frames (1 of each 4, drawn from ``--seed``), then prints the answer and
the five most probable. It runs on the card, the kernels on, unless
``--device cpu`` is given. ``--int8_trunk true`` runs the trunk's dynamic
int8 convs, as the JAX entry point does. ``--int8_stem true`` changes
nothing here, as there: with no calibration batch ``load_stem`` gives the
stem in ``--compute_dtype``.

    python -m videonavqa_tpu_torch.cli.predict --model film_attn_pt \\
        --checkpoint_path e0_film.npz --data_dir /path/to/data \\
        --video /path/to/videos/house_0001.npy \\
        --question "Is there a blue table in the kitchen?"
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from videonavqa_tpu_torch.cli.common import (
    build_q_and_v_parser, cfg_from_args, load_stem, refuse_unported)
from videonavqa_tpu_torch.data.pipeline import DataPaths, _decode_video, load_json, subsample_frames
from videonavqa_tpu_torch.datagen.encode import tokenize
from videonavqa_tpu_torch.datagen.ontology import ANSWER_VOCAB
from videonavqa_tpu_torch.models import get_model
from videonavqa_tpu_torch.serve.engine import InferenceEngine
from videonavqa_tpu_torch.utils import constants as C
from videonavqa_tpu_torch.utils.device import resolve_device

CLASS_TO_ANSWER = {v: k for k, v in ANSWER_VOCAB.items()}


def main(argv=None):
    parser = build_q_and_v_parser()
    parser.add_argument("--video", type=str, required=True,
                        help="path to an .mp4/.npy video (extension optional)")
    parser.add_argument("--question", type=str, required=True)
    args = parser.parse_args(argv)
    if not args.model:
        raise SystemExit("--model is required")
    if not args.checkpoint_path or not os.path.exists(args.checkpoint_path):
        raise SystemExit("--checkpoint_path is required for inference")
    refuse_unported(args, args.model)
    if args.mesh_devices:
        raise SystemExit("predict answers one question on one device; drop --mesh_devices "
                         "(the daemon, cli/serve.py, serves on a mesh)")
    device = resolve_device(args.device)

    paths = DataPaths(args.data_dir)
    vocab_path = os.path.join(args.data_dir, "vocab.json")
    if not os.path.exists(vocab_path):
        raise SystemExit(f"no vocab.json in {args.data_dir}")
    vocab = load_json(vocab_path)
    tokens = []
    for tok in tokenize(args.question):
        if tok not in vocab:
            raise SystemExit(f"token {tok!r} not in the dataset vocabulary")
        tokens.append(vocab[tok])

    video_base = args.video
    for ext in (".mp4", ".npy"):
        if video_base.endswith(ext):
            video_base = video_base[:-len(ext)]
    frames, v_len = subsample_frames(_decode_video(video_base),
                                     np.random.RandomState(args.seed))

    cfg = cfg_from_args(args, args.model)
    use_kernels = args.use_pallas_kernels
    if use_kernels is None:   # on the card, on
        use_kernels = device.type == "cuda"
    cfg = dataclasses.replace(cfg, use_pallas_kernels=bool(use_kernels))
    spec = get_model(args.model)
    eng = InferenceEngine(cfg, checkpoint_path=args.checkpoint_path, seed=args.seed,
                          max_batch=1, frame_buckets=(), device=device,
                          from_video=spec.uses_stem,
                          stem=load_stem(args, paths, device) if spec.uses_stem else None)
    with torch.inference_mode():   # no calibration: the int8 trunk runs dynamic
        logits, _ = eng.forward(eng.make_batch([(frames, v_len, tokens[:C.MAX_Q_LEN])]))
        probs = torch.softmax(logits[0].float(), dim=-1).cpu().numpy()
    top = np.argsort(-probs)[:5]
    print("Answer:", CLASS_TO_ANSWER[int(top[0])])
    for i in top:
        print(f"  {CLASS_TO_ANSWER[int(i)]:>40s}  {float(probs[i]):.4f}")
    return probs


if __name__ == "__main__":
    main()
