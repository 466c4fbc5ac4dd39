"""Video-only test-split inference (the port of the JAX package's
cli/v_only_test.py): ``--model cnn3d`` or ``cnn2d_lstm``, with
``v_only_eval``'s flags; see ``q_and_v_test`` for what it prints and writes.
The test split is read in order and unbucketed, as the JAX harness reads it."""

from videonavqa_tpu_torch.cli.common import run_test
from videonavqa_tpu_torch.cli.v_only_eval import _MODEL_MAP, build_parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.model:
        raise SystemExit("--model is required")
    return run_test(args, _MODEL_MAP[args.model], v_only=True)


if __name__ == "__main__":
    main()
