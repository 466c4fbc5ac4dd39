"""Train and validate a question + video model (the port of the JAX
package's cli/q_and_v_eval.py: the same flags, presets and checkpoints, plus
``--device``). For example, film_attn_pt at its eval.sh preset on the card:

    python -m videonavqa_tpu_torch.cli.q_and_v_eval --model film_attn_pt \
        --data_dir /path/to/data --batch_size 32 --l_rate 1e-4 \
        --num_res_blocks 5 --num_res_block_channels 1024 --loss_reduction sum \
        --checkpoint_path film_attn.ckpt
"""

from videonavqa_tpu_torch.cli.common import build_q_and_v_parser, run_training


def main(argv=None):
    args = build_q_and_v_parser().parse_args(argv)
    if not args.model:
        raise SystemExit("--model is required")
    return run_training(args, args.model, clip_value=args.clip_value)


if __name__ == "__main__":
    main()
