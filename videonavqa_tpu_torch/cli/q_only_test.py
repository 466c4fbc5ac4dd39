"""Question-only test-split inference (the port of the JAX package's
cli/q_only_test.py): ``--model lstm`` or ``bow``, with ``q_only_eval``'s
flags; see ``q_and_v_test`` for what it prints and writes."""

from videonavqa_tpu_torch.cli.common import run_test
from videonavqa_tpu_torch.cli.q_only_eval import build_parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.model:
        raise SystemExit("--model is required")
    return run_test(args, args.model, q_only=True)


if __name__ == "__main__":
    main()
