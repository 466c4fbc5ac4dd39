"""Nothing the benchmark runs loads JAX or the JAX package, and the reference
loads nothing of the measured package either; names are compared whole, by
their top-level part."""

import subprocess
import sys
import types

from vnqa_bench import harness

CHECK = """
import sys
sys.path.insert(0, {root!r})
{imports}
bad = sorted(m for m in sys.modules if m.split('.')[0] in {forbidden!r})
print(repr(bad))
"""


def loaded(imports, forbidden):
    code = CHECK.format(root=str(harness.ROOT), imports=imports, forbidden=forbidden)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=300)
    return eval(out.stdout.strip().splitlines()[-1])


def test_the_harness_and_the_program_it_drives_load_no_jax():
    imports = "\n".join([
        "import vnqa_bench.harness, vnqa_bench.serving, vnqa_bench.trace",
        "import vnqa_bench.traffic.bulk, vnqa_bench.traffic.open_loop, vnqa_bench.traffic.train",
        "import videonavqa_tpu_torch.serve.engine, videonavqa_tpu_torch.serve.batcher",
        "import videonavqa_tpu_torch.train.step, videonavqa_tpu_torch.data.prefetch",
        "import videonavqa_tpu_torch.stem",
        "from vnqa_bench import harness",
        "[harness.metric_reader(m['name']) for m in harness.manifest()['per_layer']]",
    ])
    assert loaded(imports, ("jax", "jaxlib", "flax", "videonavqa_tpu")) == []


def test_the_reference_loads_neither_package():
    imports = "import vnqa_bench.reference.film_attn, vnqa_bench.reference.mac, " \
              "vnqa_bench.reference.stem"
    assert loaded(imports, ("jax", "jaxlib", "flax", "videonavqa_tpu",
                            "videonavqa_tpu_torch")) == []


def test_names_are_compared_whole(monkeypatch):
    for name in ("videonavqa_tpu_torch_probe", "videonavqa_tpu_torch.probe", "jaxtyping_probe"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "videonavqa_tpu.probe", types.ModuleType("probe"))
    monkeypatch.setitem(sys.modules, "jax.probe", types.ModuleType("probe"))
    assert harness.forbidden_modules() == ["jax.probe", "videonavqa_tpu.probe"]
