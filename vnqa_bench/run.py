"""Run one cell of the benchmark once.

    python3 vnqa_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the measured package. It needs a CUDA
card; without one (or with fewer than the cell asks for) it exits non-zero
and prints no result. ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics from a profiled window. ``--control``,
``--fault`` and ``--rates`` are for setting the limits and the cells: the
first also computes the cell's control (the reference in a lower precision)
and prints its numbers, the second plants a fault of ``vnqa_bench/faults.py``
under the timed path, the third replaces the cell's arrival rate (open-loop
cells).
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".vnqa_bench_cache"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--rates", type=float, nargs="*")
    args = ap.parse_args(argv)

    # every build and kernel cache of the run inside the checkout, at fixed paths
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, str(ROOT))

    import torch

    from vnqa_bench import harness

    if not torch.cuda.is_available():
        harness.log("no CUDA card: the benchmark measures the card and has no CPU result")
        return 2
    chips = harness.cell_spec(args.workload)["chips"]
    if torch.cuda.device_count() < chips:
        harness.log(f"{args.workload} needs {chips} cards, {torch.cuda.device_count()} found")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    with contextlib.ExitStack() as stack:
        if args.fault:
            from vnqa_bench.faults import FAULTS

            stack.enter_context(FAULTS[args.fault]())
        result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                  device, T_START, control=args.control, rates=args.rates)
    found = harness.forbidden_modules()
    if found:
        harness.log(f"the run loaded modules it must not: {found}")
        return 3
    harness.report_compared(result["compared"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
