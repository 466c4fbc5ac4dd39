"""BENCHMARK.json against the benchmark's contract, and the files it names."""

import re

import pytest

from vnqa_bench import harness

BENCH = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and all(line(w) for w in BENCH["command"])
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert (harness.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_the_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("key", list(KEYS))
def test_entries(key):
    entries = BENCH[key]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = {"workloads"} if key in ("end_to_end", "per_layer") else set()
        assert KEYS[key] <= set(e) <= KEYS[key] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        if "why" in e:
            assert line(e["why"])
        if "layer" in e:
            assert line(e["layer"])


def test_configs():
    for c in BENCH["configs"]:
        assert line(c["source"]) and c["source"].startswith("https://")
        assert c["file"].startswith("vnqa_bench/") and (harness.ROOT / c["file"]).exists()
        assert c["file"] == f"vnqa_bench/configs/{c['name']}.json"
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_workloads():
    assert 1 <= len(BENCH["workloads"]) <= 24
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])
    kinds = {p.stem for p in (harness.BENCH / "traffic").glob("*.py")}
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        cell = harness.cell_spec(w["name"], BENCH)
        assert cell["kind"] in kinds
        assert cell["controls"] and cell["limits"]
        reported = harness.cell_metrics(BENCH, w["name"], "end_to_end")
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert harness.cell_metrics(BENCH, w["name"], "per_layer")


def test_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").exists()
        for cell in m.get("workloads", []):
            assert cell in cells
            reports = {x["name"] for x in harness.cell_metrics(BENCH, cell, "end_to_end")}
            assert m["moves"] in reports, (m["name"], cell)
        if m["name"].startswith("roofline_pct.") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def test_no_data_file_is_ignored_by_git():
    for p in harness.BENCH.rglob("*"):
        assert p.suffix not in (".jsonl", ".log"), p
