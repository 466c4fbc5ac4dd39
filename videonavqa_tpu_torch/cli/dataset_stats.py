"""Dataset statistics CLI (the port of the JAX package's cli/dataset_stats.py;
scripts/stats_for_generated_questions.py): split sizes, per-template
question/answer distributions, observed answer classes."""

import argparse
import json
import os
import pprint as pp

from videonavqa_tpu_torch.datagen.split import build_split, split_houses
from videonavqa_tpu_torch.datagen.stats import dataset_stats


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", type=str, required=True,
                        help="directory of per-house question JSONs")
    parser.add_argument("--split_file", type=str, default=None,
                        help="print split sizes from this split.json")
    args = parser.parse_args(argv)

    if args.split_file and os.path.exists(args.split_file):
        with open(args.split_file) as f:
            split = json.load(f)
        print("Examples in each dataset split:")
        for k in split:
            print(k, len(split[k]))

    stats = dataset_stats(args.data_dir)
    print(">>> STATS:", stats["total_questions"], "QUESTIONS,",
          stats["unique_questions"], "UNIQUE ONES.")
    print("Number of classes:", stats["num_classes"])
    pp.pprint(stats["classes"])
    print("QUESTIONS GENERATED PER TEMPLATE")
    pp.pprint(stats["count_per_template"])
    print("ANSWER DISTRIBUTION PER TEMPLATE")
    pp.pprint(stats["answers_per_template"])


if __name__ == "__main__":
    main()
