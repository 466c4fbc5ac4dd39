"""Pack a dataset directory into one .vnr record file per split, for the
native batch loader (``--use_vnr true``; data/vnr.py):

    python -m videonavqa_tpu_torch.cli.pack_dataset --data_dir /tmp/data
"""

import argparse
import os
import time

from videonavqa_tpu_torch.data import DataPaths, load_json
from videonavqa_tpu_torch.data.vnr import ensure_built, pack_dataset


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--splits", type=str, default="train,val,test")
    parser.add_argument("--no_compress", action="store_true")
    args = parser.parse_args(argv)

    ensure_built()
    split = load_json(DataPaths(args.data_dir).split_file)
    for part in args.splits.split(","):
        ids = split.get(part, [])
        if not ids:
            print(f"{part}: empty split, skipping")
            continue
        out = os.path.join(args.data_dir, f"{part}.vnr")
        t0 = time.time()
        pack_dataset(args.data_dir, out, ids, compress=not args.no_compress)
        size_mb = os.path.getsize(out) / 1e6
        print(f"{part}: {len(ids)} examples -> {out} "
              f"({size_mb:.1f} MB, {time.time() - t0:.1f}s)")


if __name__ == "__main__":
    main()
