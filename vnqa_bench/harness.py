"""The benchmark's harness: one cell, one seed, one run.

Everything that belongs to one configuration, one cell or one per-layer
metric is found by its name in ``BENCHMARK.json``:

- ``configs/<config>.json``: the configuration's sizes and how it is served
  or trained;
- ``workloads/<cell>.json``: the cell's traffic parameters, its ``kind`` and
  the limits of its correctness check;
- ``traffic/<kind>.py``: the code that drives that kind of traffic (``run(ctx)``);
- ``metrics/<metric>.py``: a reader of the traced run (``read(rec)``), which
  returns None where it finds nothing to read.

A run prints, as the last line of its standard output, one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics`` and ``device`` (and, when
traced, ``breakdown``), its compared numbers last under ``compared``; the same
numbers beside their limits are the last lines of its standard error.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "videonavqa_tpu")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def manifest():
    return load_json(ROOT / "BENCHMARK.json")


def cell_spec(name, bench=None):
    """The cell's BENCHMARK.json entry merged with its workloads/<cell>.json."""
    bench = bench or manifest()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"unknown workload {name!r}")
    return {**load_json(BENCH / "workloads" / f"{name}.json"), **entry}


def config_spec(name):
    return load_json(BENCH / "configs" / f"{name}.json")


def metric_reader(name):
    spec = importlib.util.spec_from_file_location(f"vnqa_bench_metric_{name}",
                                                  BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench, cell, key):
    """The metrics of ``bench[key]`` this cell reports: those that list it, or
    that list no cells and (per-layer) move an end-to-end metric it reports."""
    e2e = {m["name"] for m in cell_metrics(bench, cell, "end_to_end")} if key == "per_layer" \
        else None
    out = []
    for m in bench[key]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif e2e is None or m["moves"] in e2e:
            out.append(m)
    return out


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


class Ctx:
    """What the code of a traffic kind gets: the cell, its configuration, the run's
    options, the device, and where it leaves what the readers read."""

    def __init__(self, cell, config, seed, seconds, traced, device, t_start, *, control=None,
                 rates=None, model_overrides=None, cell_overrides=None):
        self.cell, self.config = {**cell, **(cell_overrides or {})}, config
        self.seed, self.seconds, self.traced = seed, seconds, traced
        self.device, self.t_start = device, t_start
        self.control = control
        self.rates = rates
        self.model_overrides = model_overrides or {}
        self.pool = self.cell["pool"]
        self.rec = {}             # for the per-layer readers

    def model_cfg(self):
        return {**self.config["model"], **self.model_overrides}

    def note(self, msg):
        log(msg)

    def setup_done(self):
        """Called right before the first timed request or step."""
        self.setup_s = time.time() - self.t_start


def run_cell(name, seed, seconds, traced, device, t_start, **options):
    """One run of cell ``name`` -> the result object (without the checks of
    the process that prints it)."""
    import torch

    # the configurations state float32 where they do not state bf16 or int8;
    # PyTorch's default lets cuDNN run float32 convs (the int8 calibration
    # pass) in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = manifest()
    cell = cell_spec(name, bench)
    config = config_spec(cell["config"])
    ctx = Ctx(cell, config, seed, seconds, traced, device, t_start, **options)
    kind = importlib.import_module(f"vnqa_bench.traffic.{cell['kind']}")
    out = kind.run(ctx)

    metrics = {}
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    if traced:
        trace = out["trace"]
        busy, window = trace.busy_s(), trace.window_s
        ctx.rec.update(busy_s=busy, window_s=window, kernel_s=trace.kernel_s())
        ctx.note(f"kernel launches in the traced window: {trace.launches()}")
        if trace.device_ops:
            first = min(a for _, a, _ in trace.device_ops) - trace.lo
            last = trace.hi - max(b for _, _, b in trace.device_ops)
            ctx.note(f"{len(trace.device_ops)} device ops; the first starts {first:.6f} s into"
                     f" the window, the last ends {last:.6f} s before its close")
        for m in cell_metrics(bench, name, "per_layer"):
            value = metric_reader(m["name"])(ctx.rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out["metrics"], setup_s=ctx.setup_s)
        for m in cell_metrics(bench, name, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": units[m["name"]]}
    is_cuda = device.type == "cuda"
    result = {
        "correct": out["correct"],
        "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": metrics,
        "device": {"platform": "gpu" if is_cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if is_cuda else "cpu",
                   "count": 1,
                   "memory_peak_bytes": out.get("memory_peak_bytes", 0)},
    }
    if traced:
        result["device"].update(busy_s=busy, window_s=window)
        result["breakdown"] = trace.breakdown()
    if "control" in ctx.rec:
        result["control"] = ctx.rec["control"]
    result["compared"] = out["compared"]          # last, as the contract asks
    return result


def report_compared(compared):
    """The compared numbers beside their limits, one line each."""
    for name, (value, limit) in compared.items():
        log(f"compared {name}: {value!r} limit {limit!r} "
            f"{'ok' if value <= limit else 'OVER THE LIMIT'}")
