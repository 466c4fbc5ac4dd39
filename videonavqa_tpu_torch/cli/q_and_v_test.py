"""Test-split inference for a question + video model (the port of the JAX
package's cli/q_and_v_test.py: the same flags as ``q_and_v_eval``, plus
``--device``). It restores a required checkpoint, pads the final partial
batch, prints the per-class accuracies and F1 under "Testing", and writes
``t_``/``p_``/``q_<checkpoint name>.npy`` beside the checkpoint for
``results_analysis``. For example, film_gp_pt at its eval.sh preset:

    python -m videonavqa_tpu_torch.cli.q_and_v_test --model film_gp_pt \\
        --data_dir /path/to/data --batch_size 32 --num_res_blocks 4 \\
        --num_res_block_channels 1024 --num_tail_channels 32 \\
        --checkpoint_path e0_gp.npz
"""

from videonavqa_tpu_torch.cli.common import build_q_and_v_parser, run_test


def main(argv=None):
    args = build_q_and_v_parser().parse_args(argv)
    if not args.model:
        raise SystemExit("--model is required")
    return run_test(args, args.model)


if __name__ == "__main__":
    main()
