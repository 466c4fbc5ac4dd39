"""Train and validate a video-only model (the port of the JAX package's
cli/v_only_eval.py): ``--model cnn3d`` or ``cnn2d_lstm``.

``--bucket_frames`` is the port's own flag here (the JAX parser's v_only
harness has none, though its ``run_training`` reads it): videos of like
length go together and the frame axis is trimmed to bucket sizes, which the
C3D answers exactly through its zero-run splice."""

import argparse

from videonavqa_tpu_torch.cli.common import add_common_args, run_training

_MODEL_MAP = {"cnn3d": "v_only_cnn3d", "cnn2d_lstm": "v_only_cnn2d_lstm"}


def build_parser():
    parser = argparse.ArgumentParser()
    add_common_args(parser)
    parser.add_argument("--model", type=str, choices=sorted(_MODEL_MAP))
    parser.add_argument("--hidden_size", type=int, default=128)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--clip_value", type=float, default=1.0)
    parser.add_argument("--l_rate", type=float, default=1e-4)
    parser.add_argument("--loss_reduction", type=str, default="mean",
                        choices=["sum", "mean", "elementwise_mean"])
    parser.add_argument("--num_epochs", type=int, default=1)
    parser.add_argument("--use_class_weights", type=lambda s: s.lower() == "true",
                        default=False)
    parser.add_argument("--stats_after_every", type=int, default=400)
    parser.add_argument("--val_only", type=lambda s: s.lower() == "true", default=False)
    parser.add_argument("--bucket_frames",
                        type=lambda s: "auto" if s.lower() == "auto" else s.lower() == "true",
                        default=False,
                        help="group videos of like length per batch and trim the frame axis "
                             "to bucket sizes ('auto': the cost-optimal edges)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.model:
        raise SystemExit("--model is required")
    return run_training(args, _MODEL_MAP[args.model], v_only=True, clip_value=args.clip_value)


if __name__ == "__main__":
    main()
