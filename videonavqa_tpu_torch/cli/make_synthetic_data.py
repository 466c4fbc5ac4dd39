"""Write a synthetic dataset fixture (see data/synthetic.py):

    python -m videonavqa_tpu_torch.cli.make_synthetic_data --out /tmp/data \
        --video_format npy --max_frames 40
"""

import argparse

from videonavqa_tpu_torch.data.synthetic import generate_synthetic_dataset


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--num_houses", type=int, default=3)
    parser.add_argument("--trajs_per_house", type=int, default=6)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--video_format", type=str, default="mp4", choices=["mp4", "npy"])
    parser.add_argument("--max_frames", type=int, default=120)
    args = parser.parse_args(argv)
    ids = generate_synthetic_dataset(
        args.out, num_houses=args.num_houses, trajs_per_house=args.trajs_per_house,
        seed=args.seed, video_format=args.video_format, max_frames=args.max_frames)
    print("wrote %d examples to %s" % (len(ids), args.out))


if __name__ == "__main__":
    main()
