"""Export a checkpoint to the reference's PyTorch format (the port of the JAX
package's cli/export_checkpoint.py: the same flags and models).

It reads an npz checkpoint, the port's or the JAX package's (one format),
and writes the ``torch.save`` layout the reference harness resumes and
evaluates from (``{'epoch', 'model', 'state_dict'}``), with the reference's
layer names and OIHW conv kernels. ``--checkpoint_path`` of any entry point
reads such a file back.

    python -m videonavqa_tpu_torch.cli.export_checkpoint --model film_attn_pt \\
        --checkpoint_path e3_at.npz --out at_sum_1e-4.pt \\
        [the model-dimension flags used in training]

The FiLM models' conv1x1 skip weights are dropped, as in every real
reference checkpoint (plain-list layers outside state_dict); the npz
checkpoints are the full-fidelity round trip. It runs on the CPU.
"""

from __future__ import annotations

import os

import torch

from videonavqa_tpu_torch.cli.common import build_q_and_v_parser, cfg_from_args
from videonavqa_tpu_torch.models import get_model
from videonavqa_tpu_torch.utils import checkpoint as ckpt
from videonavqa_tpu_torch.utils.zoo_export import save_reference_checkpoint

ZOO = ["bow", "lstm", "v_only_cnn3d", "v_only_cnn2d_lstm", "concat2d",
       "concat3d", "film_gp_pt", "film_attn_pt", "time_multi_hop", "mac"]


def main(argv=None):
    parser = build_q_and_v_parser()
    parser.add_argument("--out", type=str, required=True,
                        help="output .pt path (reference torch format)")
    # exports cover the whole zoo, not just the q_and_v harness's models
    for action in parser._actions:
        if action.dest == "model":
            action.choices = ZOO
    args = parser.parse_args(argv)
    if not args.model:
        raise SystemExit("--model is required")
    if not args.checkpoint_path or not os.path.exists(args.checkpoint_path):
        raise SystemExit("--checkpoint_path must point at an npz checkpoint")

    cfg = cfg_from_args(args, args.model)
    params, state = get_model(args.model).init(torch.Generator().manual_seed(args.seed), cfg,
                                               torch.device("cpu"))
    meta = ckpt.load_checkpoint(args.checkpoint_path, params=params, state=state)
    epoch = int(meta.get("epoch", 0))
    save_reference_checkpoint(args.out, args.model, params, state, cfg, epoch=epoch)
    print(f"=> Exported {args.model} (epoch {epoch}) to {args.out}")


if __name__ == "__main__":
    main()
