"""The port's dataset generator against the JAX package's, on the CPU.

``videonavqa_tpu_torch/datagen/`` (geometry, scene, templates, programs, text,
generator, engine, labels, split, stats, vision, renderer, trajectory, the
House3D seam, the assets), ``cli/generate_dataset.py`` and
``cli/dataset_stats.py`` are numpy copies of the JAX package's, so everything
here is held to exact equality: the same values, the same printed lines and
the same bytes on disk.

The generator gives each attempt a wall-clock budget (``datagen/engine.py``:
0.5 s, 0.8 s for relation templates) and abandons it past that, so two runs
on a loaded machine can differ wherever an attempt times out. Wherever these
tests compare two runs in one process, both packages' ``datagen.engine`` and
``datagen.generator`` modules get one deterministic clock (``StepClock``:
``perf_counter`` advances CLOCK_STEP a call, started afresh for each run), so
the timeouts fire at the same attempt in both and the timeout path itself is
compared (the 3-house runs below time out 12 times). Spawned workers do not
see a patched clock: the ``--workers`` test runs on the real clock, as the
JAX package's own test does.
"""

import contextlib
import dataclasses
import enum
import filecmp
import hashlib
import io
import json
import os
import random
import re
import stat
import subprocess

import numpy as np
import pytest
# The House3D fake: a House3DUtils surface, an Environment and the fixture
# that installs a House3D.objrender module.
from test_house3d_backend import _OBJ_COLORS, HOUSE_ID, _FakeEnv, _FakeUtils
from test_house3d_backend import fake_house3d  # noqa: F401

import videonavqa_tpu.datagen.engine as jengine
import videonavqa_tpu.datagen.generator as jgenerator
import videonavqa_tpu_torch.datagen.engine as tengine
import videonavqa_tpu_torch.datagen.generator as tgenerator
from videonavqa_tpu.cli import dataset_stats as jstats_cli
from videonavqa_tpu.cli import generate_dataset as jgen_cli
from videonavqa_tpu.data import pipeline as jpipeline
from videonavqa_tpu.datagen import assets as jassets
from videonavqa_tpu.datagen import geometry as jgeometry
from videonavqa_tpu.datagen import house3d_backend as jh3d
from videonavqa_tpu.datagen import programs as jprograms
from videonavqa_tpu.datagen import renderer as jrenderer
from videonavqa_tpu.datagen import scene as jscene
from videonavqa_tpu.datagen import templates as jtemplates
from videonavqa_tpu.datagen import text as jtext
from videonavqa_tpu.datagen import trajectory as jtrajectory
from videonavqa_tpu.datagen import vision as jvision
from videonavqa_tpu_torch.cli import dataset_stats as tstats_cli
from videonavqa_tpu_torch.cli import generate_dataset as tgen_cli
from videonavqa_tpu_torch.data import pipeline as tpipeline
from videonavqa_tpu_torch.datagen import assets, geometry, house3d_backend, programs
from videonavqa_tpu_torch.datagen import renderer, scene, templates, text, trajectory, vision
from videonavqa_tpu_torch.datagen.encode import build_vocab
from videonavqa_tpu_torch.datagen.engine import REL_TEMPLATE_IDS, QuestionEngine
from videonavqa_tpu_torch.datagen.generator import GenerationTimeout, QuestionGenerator
from videonavqa_tpu_torch.datagen.ontology import (
    ALL_SIMPLE_ROOM_TYPES, ANSWER_VOCAB, QUERY_OBJECTS,
)
from videonavqa_tpu_torch.datagen.programs import EvalContext, GenerationError, OPS
from videonavqa_tpu_torch.datagen.scene import HouseObject, HouseRoom, SceneGraph
from videonavqa_tpu_torch.datagen.templates import (
    NUM_TEMPLATES, SORTED_TEMPLATE_KEYS, TEMPLATES,
)

CLOCK_STEP = 1e-3   # seconds a perf_counter call: a 0.5 s budget is 500 calls
SMALL = ["--num_houses", "3", "--trajs_per_house", "3", "--seed", "0"]


class StepClock:
    """A ``time`` module stand-in whose perf_counter advances a fixed step
    each call."""

    def __init__(self, step=CLOCK_STEP):
        self.calls, self.step = 0, step

    def perf_counter(self):
        self.calls += 1
        return self.calls * self.step


@contextlib.contextmanager
def step_clock(monkeypatch):
    """Both packages' engine and generator on one fresh StepClock."""
    clock = StepClock()
    with monkeypatch.context() as m:
        for mod in (jengine, jgenerator, tengine, tgenerator):
            m.setattr(mod, "time", clock)
        yield clock


@contextlib.contextmanager
def counted_timeouts(monkeypatch):
    """[n]: the GenerationTimeouts the port's generator raises in the block."""
    seen = [0]
    orig = tgenerator.QuestionGenerator.generate_example

    def generate_example(self, *a, **k):
        try:
            return orig(self, *a, **k)
        except tgenerator.GenerationTimeout:
            seen[0] += 1
            raise

    with monkeypatch.context() as m:
        m.setattr(tgenerator.QuestionGenerator, "generate_example", generate_example)
        yield seen


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, n), root)
                  for d, _, names in os.walk(root) for n in names)


def _differing(a, b, names):
    return [n for n in names if not filecmp.cmp(os.path.join(a, n), os.path.join(b, n),
                                                shallow=False)]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """{'jax', 'port', 'npy'}: SMALL generated by the JAX package (mp4), by
    the port (mp4) and by the port with --video_format npy, each on a fresh
    StepClock; 'timeouts': the port's mp4 run's GenerationTimeouts."""
    root = tmp_path_factory.mktemp("gen")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, main, extra in (("jax", jgen_cli.main, []), ("port", tgen_cli.main, []),
                                  ("npy", tgen_cli.main, ["--video_format", "npy"])):
            out[name] = str(root / name)
            with step_clock(mp), counted_timeouts(mp) as seen, \
                    contextlib.redirect_stdout(io.StringIO()) as printed:
                main(["--out", out[name]] + SMALL + extra)
            out[name + "_stdout"] = printed.getvalue()
            if name == "port":
                out["timeouts"] = seen[0]
    return out


# ---------------------------------------------------------------- the copies' tables

@pytest.mark.parametrize("name", ["colormap_coarse.csv", "object_id_to_colors.npy",
                                  "__init__.py"])
def test_assets_are_the_jax_packages_bytes(name):
    def digest(mod):
        with open(os.path.join(os.path.dirname(mod.__file__), name), "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    assert digest(assets) == digest(jassets)
    assert os.path.dirname(assets.COLORMAP_COARSE_CSV) == os.path.dirname(assets.__file__)
    assert os.path.dirname(assets.OBJECT_ID_TO_COLORS_NPY) == os.path.dirname(assets.__file__)


def _plain(value):
    """Enums by name, classes by name, containers element by element."""
    if isinstance(value, enum.Enum):
        return ("enum", value.name)
    if isinstance(value, type):
        return ("type", value.__name__)
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    return value


def test_template_registries_are_the_jax_packages():
    assert _plain(TEMPLATES) == _plain(jtemplates.TEMPLATES)
    assert list(TEMPLATES) == list(jtemplates.TEMPLATES)
    assert SORTED_TEMPLATE_KEYS == jtemplates.SORTED_TEMPLATE_KEYS
    assert templates.FINE_GRAINED_ROOM_COUNT_TEMPLATES == \
        jtemplates.FINE_GRAINED_ROOM_COUNT_TEMPLATES
    assert templates.SET_SIZES == jtemplates.SET_SIZES
    assert list(OPS) == list(jprograms.OPS)
    assert REL_TEMPLATE_IDS == jengine.REL_TEMPLATE_IDS
    assert (tengine.TIMEOUT, tengine.TIMEOUT_REL, tengine.MAX_COUNT_ANSWER) == \
        (jengine.TIMEOUT, jengine.TIMEOUT_REL, jengine.MAX_COUNT_ANSWER)
    assert tgenerator.TAG_TYPES == jgenerator.TAG_TYPES


def test_renderer_tables_are_the_jax_packages():
    for name in ("ANSWER_COLORS", "ROOM_TYPE_CHOICES", "COMPOSITE_ROOM_CHOICES",
                 "OBJ_CLASS_CHOICES", "SEMANTIC_COLORS", "RGB_TO_OBJECT", "_BGR_OF_COLOR"):
        assert getattr(renderer, name) == getattr(jrenderer, name), name
    assert vision.DEPTH_SCALE == jvision.DEPTH_SCALE
    assert vision.load_semantic_colormap(assets.COLORMAP_COARSE_CSV) == \
        jvision.load_semantic_colormap(jassets.COLORMAP_COARSE_CSV)


def _seeded_boxes(seed, n=8):
    """n random boxes, then for each one box inside it and one resting on it
    (so containment, 'on' and 'next_to' all occur)."""
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        lo = r.uniform(0, 4, 3)
        out.append({"min": list(lo), "max": list(lo + r.uniform(0.1, 1.5, 3))})
    for b in out[:n]:
        lo, hi = np.array(b["min"]), np.array(b["max"])
        mid = (lo + hi) / 2
        out.append({"min": list(mid - (hi - lo) / 4), "max": list(mid + (hi - lo) / 4)})
        base = np.array([mid[0], hi[1] + r.uniform(0, 0.15), mid[2]])
        out.append({"min": list(base), "max": list(base + r.uniform(0.1, 0.5, 3))})
    return out


@pytest.mark.parametrize("fn", ["bbox_volume", "bbox_larger", "is_contained",
                                "closest_distance", "horizontal_distance",
                                "point_distance_object", "nearby_pairs"])
def test_geometry_matches_jax_on_seeded_boxes(fn):
    boxes = _seeded_boxes(5)
    port, ref = getattr(geometry, fn), getattr(jgeometry, fn)
    objs = [{"bbox": b} for b in boxes]
    if fn == "bbox_volume":
        cases = [((b,), {}) for b in boxes]
    elif fn == "bbox_larger":
        cases = [((a, b, t), {}) for a in boxes for b in boxes for t in (0.0, 0.1, 0.5)]
    elif fn == "is_contained":
        cases = [((a, b, ax), {}) for a in objs for b in objs for ax in range(3)]
    elif fn in ("closest_distance", "horizontal_distance"):
        cases = [((a, b), {}) for a in objs for b in objs]
    elif fn == "point_distance_object":
        pts = np.random.RandomState(6).uniform(0, 5, (6, 3))
        cases = [((list(p), o), {}) for p in pts for o in objs]
    else:
        def items(mod):
            return [mod.ItemInfo(f"o{i}", {"bbox": b, "node": str(i)})
                    for i, b in enumerate(boxes)]

        got = port(items(scene), hthreshold=0.3, vthreshold=0.2)
        want = ref(items(jscene), hthreshold=0.3, vthreshold=0.2)
        assert list(got) == list(want)
        for rel in want:
            assert [(a.name, b.name, *r) for a, b, *r in got[rel]] == \
                [(a.name, b.name, *r) for a, b, *r in want[rel]], rel
        assert want["on"] and want["next_to"]
        return
    got = [port(*args, **kw) for args, kw in cases]
    assert got == [ref(*args, **kw) for args, kw in cases]
    if fn in ("bbox_larger", "is_contained"):
        assert 0 < sum(got) < len(got)


def _seeded_instantiation(key, seed):
    """(tag_instantiations, set_size) for template ``key``, drawn from
    ``seed`` over the ontology's words, in the generator's shapes."""
    r = random.Random(seed)
    set_size = r.choice(TEMPLATES[key]["set_size"]) if "set_size" in TEMPLATES[key] else None
    tags = []
    for tag in re.findall("<(.*?)>", key):
        tags += [tag.replace("{}", str(i + 1)) for i in range(set_size)] if "{}" in tag \
            else [tag]
    inst = {}
    for tag in tags:
        tag = tag[:-3] if tag.endswith("-pl") else tag
        base = re.sub("[0-9]", "", tag)
        if base == "obj_type":
            inst[tag] = {"value": r.choice(sorted(QUERY_OBJECTS)), "type": base}
        elif base == "room_type":
            inst[tag] = {"value": r.choice(ALL_SIMPLE_ROOM_TYPES), "type": base}
        elif base == "color":
            inst[tag] = {"value": r.choice(renderer.ANSWER_COLORS), "type": base}
        elif base == "rel":
            inst[tag] = {"value": r.choice(["on", "next_to"]), "type": base}
        elif base == "comp":
            inst[tag] = {"value": r.choice(["more", "fewer"]), "type": base}
        elif base == "comp_rel":
            inst[tag] = {"value": "bigger", "type": base}
        elif base == "comp_sup":
            inst[tag] = {"value": "biggest", "type": base}
        elif base == "attr":
            value, types = [], []
            if r.random() < 0.6:
                value.append(r.choice(renderer.ANSWER_COLORS))
                types.append("color")
            if r.random() < 0.6:
                value.append(r.choice(ALL_SIMPLE_ROOM_TYPES + ["everywhere"]))
                types.append("room_location")
            inst[tag] = {"value": value, "type": types}
    return inst, set_size


@pytest.mark.parametrize("q_id", range(29))
def test_realize_question_matches_jax(q_id):
    key = SORTED_TEMPLATE_KEYS[q_id]
    for seed in range(6):
        inst, set_size = _seeded_instantiation(key, 100 * q_id + seed)
        got = text.realize_question(key, json.loads(json.dumps(inst)), set_size=set_size)
        want = jtext.realize_question(key, json.loads(json.dumps(inst)), set_size=set_size)
        assert got == want
        assert "<" not in got and "  " not in got


# ------------------------------------- the JAX package's datagen tests, on the port

def _box(x, z, w=1.0, d=1.0, h=1.0, y0=0.0):
    return {"min": [x, y0, z], "max": [x + w, y0 + h, z + d]}


def make_scene(all_seen=True, mod=scene):
    """Two rooms: kitchen with 2 tables (blue, green) + a brown chair;
    bedroom with 1 table (blue) and a bed (tests/test_datagen.py's)."""
    rooms = [
        mod.HouseRoom(types=["kitchen"], bbox=_box(0, 0, 6, 6, 2.5), objects=[
            mod.HouseObject("n0", "table", _box(1, 1), color="blue"),
            mod.HouseObject("n1", "table", _box(3, 3), color="green"),
            mod.HouseObject("n2", "chair", _box(1, 3), color="brown"),
        ]),
        mod.HouseRoom(types=["bedroom"], bbox=_box(6, 0, 6, 6, 2.5), objects=[
            mod.HouseObject("n3", "table", _box(7, 1), color="blue"),
            mod.HouseObject("n4", "bed", _box(9, 2, 2, 2), color="white"),
        ]),
    ]
    graph = mod.SceneGraph(rooms)
    if all_seen:
        for room in graph.rooms():
            graph.mark_visited(room)
            for slot in room["objects"].values():
                for o in slot["obj_list"]:
                    o["seen"] = True
                slot["seen_count"] = slot["count"]
    return graph


def test_template_inventory():
    assert NUM_TEMPLATES == 29
    assert SORTED_TEMPLATE_KEYS == sorted(TEMPLATES)
    assert REL_TEMPLATE_IDS
    for i in REL_TEMPLATE_IDS:
        assert "<rel>" in SORTED_TEMPLATE_KEYS[i]


_BIG, _SMALL = {"bbox": _box(0, 0, 2, 2, 2)}, {"bbox": _box(0, 0, 1, 1, 1)}


@pytest.mark.parametrize("op, args, want", [
    ("equal_set", (["a", "a"], "a"), True),
    ("equal_set", ([], "a"), False),
    ("unique", ([2, 2],), 2),
    ("comp", ("more", 3, 2), True),
    ("comp", ("fewer", 3, 2), False),
    ("comp_rel", (_BIG, _SMALL), True),
    ("comp_rel", (_SMALL, _BIG), False),
    ("comp_sup", ([_SMALL, _BIG],), _BIG),
    ("strip_nums", ("kitchen12",), "kitchen"),
])
def test_ops_semantics(op, args, want):
    assert OPS[op](EvalContext(), *args) == want


def test_ops_raise_generation_errors():
    assert sorted(OPS["intersect"](EvalContext(), [1, 2, 3], [2, 3, 4])) == [2, 3]
    with pytest.raises(GenerationError):
        OPS["unique"](EvalContext(), [1, 2])
    with pytest.raises(GenerationError):
        OPS["continue_if_non_empty"](EvalContext(), [])


def test_geometry_nearby_pairs():
    table = scene.ItemInfo("table1", {"bbox": _box(0, 0, 1, 1, 0.8), "node": "t"})
    vase = scene.ItemInfo("vase1", {"bbox": _box(0.2, 0.2, 0.2, 0.2, 0.3, y0=0.85), "node": "v"})
    chair = scene.ItemInfo("chair1", {"bbox": _box(1.2, 0, 0.5, 0.5, 1.0), "node": "c"})
    pairs = geometry.nearby_pairs([table, vase, chair], hthreshold=0.3, vthreshold=0.2)
    on_pairs = [(a.name, b.name) for a, b, _ in pairs["on"]]
    next_pairs = {(a.name, b.name) for a, b, _ in pairs["next_to"]}
    assert ("vase1", "table1") in on_pairs
    assert ("chair1", "table1") in next_pairs and ("table1", "chair1") in next_pairs


@pytest.mark.parametrize("template, answer, seed", [
    ("Is there <art> <attr> <obj_type>?", True, 0),
    ("How many <obj_type-pl> are <attr>?", 1, 0),
    ("How many <obj_type-pl> are <attr>?", 3, 1),   # 3 tables: must be the tables question
    ("What color is the <attr> <obj_type>?", "<query>:color", 0),
    ("Where is the <attr> <obj_type>?", "<query>:room_location", 0),
])
def test_generator_produces_valid_examples(template, answer, seed, monkeypatch):
    q_id = SORTED_TEMPLATE_KEYS.index(template)
    with step_clock(monkeypatch) as clock:
        q_text, q_ans = QuestionGenerator(make_scene(), random.Random(seed)).generate_example(
            q_id, answer, deadline=clock.perf_counter() + 5.0)
    assert isinstance(q_text, str) and "<" not in q_text and "  " not in q_text
    assert str(q_ans) in ANSWER_VOCAB
    if not isinstance(answer, str):
        assert q_ans == answer
    if answer == 3:
        assert "table" in q_text


def test_generator_timeout(monkeypatch):
    """An impossible count for this scene must hit the deadline."""
    q_id = SORTED_TEMPLATE_KEYS.index("How many <obj_type-pl> are <attr>?")
    gen = QuestionGenerator(make_scene(), random.Random(0))
    with step_clock(monkeypatch) as clock, pytest.raises(GenerationTimeout):
        gen.generate_example(q_id, 10, deadline=clock.perf_counter() + 0.3)
    assert clock.calls >= 300


def test_numpy_bbox_answers_json_serializable(monkeypatch):
    """comp_rel over numpy-float bboxes yields builtin bools json accepts."""
    rooms = [HouseRoom(types=["kitchen"], bbox=_box(0, 0, 8, 8, 2.5), objects=[
        HouseObject("n0", "table", {"min": list(np.float64([1, 0, 1])),
                                    "max": list(np.float64([3, 1.5, 3]))}, color="blue"),
        HouseObject("n1", "table", {"min": list(np.float64([5, 0, 5])),
                                    "max": list(np.float64([5.5, 0.5, 5.5]))}, color="green"),
    ])]
    graph = SceneGraph(rooms)
    for room in graph.rooms():
        graph.mark_visited(room)
        for slot in room["objects"].values():
            for o in slot["obj_list"]:
                o["seen"] = True
    q_id = SORTED_TEMPLATE_KEYS.index("Is the <attr1> <obj_type> <comp_rel> than the <attr2> one?")
    with step_clock(monkeypatch) as clock:
        q_text, q_ans = QuestionGenerator(graph, random.Random(0)).generate_example(
            q_id, True, deadline=clock.perf_counter() + 5.0)
    assert type(q_ans) is bool and q_ans is True
    json.dumps({"q_text": q_text, "q_ans": q_ans})


@pytest.mark.parametrize("template, inst, want", [
    ("Is there <art> <attr> <obj_type>?",
     {"attr": {"value": ["blue"], "type": ["color"]},
      "obj_type": {"value": "table", "type": "obj_type"}}, "Is there a blue table?"),
    ("How many <obj_type-pl> are <attr>?",
     {"attr": {"value": ["kitchen"], "type": ["room_location"]},
      "obj_type": {"value": "switch", "type": "obj_type"}},
     "How many switches are located in the kitchen?"),
    ("How many <obj_type-pl> are <attr>?",
     {"attr": {"value": [], "type": []}, "obj_type": {"value": "chair", "type": "obj_type"}},
     "How many chairs are there?"),
])
def test_text_realization(template, inst, want):
    assert text.realize_question(template, inst) == want


def test_engine_answer_balancing(tmp_path):
    """Bool templates alternate via the under-represented-answer rule;
    duplicates are dropped."""
    engine = QuestionEngine(str(tmp_path), random.Random(0))
    key = "Is there <art> <attr> <obj_type>?"
    assert engine._required_answers(key) == [True]
    engine.question_set[key]["ans_distribution"][True] = 2
    assert engine._required_answers(key) == [False]
    engine.question_set[key]["ans_distribution"][False] = 3
    assert engine._required_answers(key) == [True]

    count_key = "How many <obj_type-pl> are <attr>?"
    engine.question_set[count_key]["ans_distribution"][1] = 5
    order = engine._required_answers(count_key)
    assert order[0] != 1 and order[-1] == 1
    assert sorted(order) == list(range(1, 11))

    assert engine._write_example(0, 11, "Is there a table?", True, key, {})
    assert not engine._write_example(1, 11, "Is there a table?", True, key, {})
    assert engine.question_set[key]["ans_distribution"][True] == 3


# ---------------------------------------- the generator against the JAX package's

def _observed_house(mod_renderer, mod_scene, mod_trajectory, seed):
    """A synthetic house observed along one trajectory -> its scene graph."""
    rng = np.random.RandomState(seed)
    house = mod_renderer.generate_synthetic_house(rng, num_rooms=4)
    graph = mod_scene.SceneGraph(house.rooms)
    coors = mod_renderer.generate_path(house, 0, len(house.rooms) - 1, rng)
    coors = mod_trajectory.add_lookarounds(coors, graph)
    observer = mod_trajectory.TrajectoryObserver(graph, mod_renderer.SyntheticRenderer(house))
    per_frame = observer.observe(coors, return_objects_in_frames=True)
    return graph, coors, per_frame


def test_observed_scene_matches_jax():
    got = _observed_house(renderer, scene, trajectory, 3)
    want = _observed_house(jrenderer, jscene, jtrajectory, 3)
    assert np.array_equal(np.asarray(got[1]), np.asarray(want[1]))
    assert got[2] == want[2]
    assert got[0].get_all_objects(include_unseen_objects=True) == \
        want[0].get_all_objects(include_unseen_objects=True)
    assert got[0].get_all_rooms(include_unseen_rooms=True) == \
        want[0].get_all_rooms(include_unseen_rooms=True)


def _generate_all(mod_gen, graph, seed, clock):
    out = []
    for q_id, key in enumerate(SORTED_TEMPLATE_KEYS):
        gen = mod_gen.QuestionGenerator(graph, random.Random(seed + q_id))
        ans_type = TEMPLATES[key]["ans_type"]
        answer = True if ans_type is bool else 1 if ans_type is int else f"<query>:{ans_type}"
        try:
            q = gen.generate_example(q_id, answer, deadline=clock.perf_counter() + 0.5)
            out.append((q, json.loads(json.dumps(gen.tag_instantiations))))
        except mod_gen.GenerationTimeout:
            out.append("timeout")
    return out


def test_generator_matches_jax_over_every_template(monkeypatch):
    """Each template once, on one observed synthetic house, from the same
    seed and clock: the same question, answer and tags, or a timeout in
    both."""
    graph, _, _ = _observed_house(renderer, scene, trajectory, 7)
    jgraph, _, _ = _observed_house(jrenderer, jscene, jtrajectory, 7)
    with step_clock(monkeypatch) as clock:
        got = _generate_all(tgenerator, graph, 11, clock)
    with step_clock(monkeypatch) as clock:
        want = _generate_all(jgenerator, jgraph, 11, clock)
    assert got == want
    assert sum(g != "timeout" for g in got) >= 10


# ---------------------------------------------------------- generate_dataset.main

def test_generate_dataset_writes_the_jax_packages_bytes(trees):
    names = _files(trees["jax"])
    assert names == _files(trees["port"])
    assert sum(n.startswith("videos/") and n.endswith(".mp4") for n in names) >= 3
    assert not _differing(trees["jax"], trees["port"], names)
    assert trees["port_stdout"] == trees["jax_stdout"].replace(trees["jax"], trees["port"])
    assert trees["timeouts"] > 0   # the timeout path ran, at the same attempts in both


def test_npy_videos_differ_from_the_mp4_run_only_in_the_video_files(trees):
    mp4, npy = _files(trees["port"]), _files(trees["npy"])
    others = [n for n in mp4 if not n.startswith("videos/")]
    assert others == [n for n in npy if not n.startswith("videos/")]
    assert not _differing(trees["port"], trees["npy"], others)
    assert [n[:-4] for n in mp4 if n.startswith("videos/")] == \
        [n[:-4] for n in npy if n.startswith("videos/")]
    assert all(n.endswith(".npy") for n in npy if n.startswith("videos/"))

    # each .npy holds the frames its stored trajectory renders to
    checked = 0
    lengths = {}
    for h in range(3):
        house_id = f"synth{h:04d}"
        _, nprng = tgen_cli._house_rngs(0, h)
        house = renderer.generate_synthetic_house(nprng, num_rooms=4)
        trajs = np.load(os.path.join(trees["npy"], "trajectories", house_id + ".npy"),
                        allow_pickle=True)
        with open(os.path.join(trees["npy"], "trajectories",
                               house_id + "_video_lengths.json")) as f:
            lengths.update({f"{house_id}_{int(k):04d}": v for k, v in json.load(f).items()})
        for t, traj in enumerate(trajs):
            path = os.path.join(trees["npy"], "videos", "%s_%04d.npy" % (house_id, t))
            if not os.path.exists(path):
                continue
            observer = trajectory.TrajectoryObserver(SceneGraph(house.rooms),
                                                     renderer.SyntheticRenderer(house))
            want = observer.render_video([tuple(p) for p in traj])
            got = np.load(path)
            assert got.dtype == np.uint8 and got.shape == (lengths[f"{house_id}_{t:04d}"],
                                                            160, 208, 3)
            assert np.array_equal(got, want), path
            checked += 1
    assert checked == sum(n.startswith("videos/") for n in npy)


def test_workers_match_the_sequential_run(tmp_path):
    """--workers 3 (spawned processes) writes the bytes --workers 1 writes,
    on the real clock (tests/test_datagen.py's counterpart)."""
    seq, par = str(tmp_path / "seq"), str(tmp_path / "par")
    common = ["--num_houses", "6", "--trajs_per_house", "2", "--seed", "4",
              "--video_format", "npy"]
    with contextlib.redirect_stdout(io.StringIO()):
        tgen_cli.main(["--out", seq, "--workers", "1"] + common)
        tgen_cli.main(["--out", par, "--workers", "3"] + common)
    names = _files(seq)
    assert names and names == _files(par)
    assert not _differing(seq, par, names)


def test_resume_skips_the_houses_already_written(trees, tmp_path, monkeypatch):
    out = str(tmp_path / "resumed")
    os.makedirs(os.path.join(out, "questions"))
    for house_id in ("synth0000", "synth0001"):
        with open(os.path.join(trees["npy"], "questions", house_id + ".json")) as f:
            kept = f.read()
        with open(os.path.join(out, "questions", house_id + ".json"), "w") as f:
            f.write(kept)
    with step_clock(monkeypatch), contextlib.redirect_stdout(io.StringIO()) as printed:
        tgen_cli.main(["--out", out, "--resume", "--video_format", "npy"] + SMALL)
    assert "synth0000: 0 examples\nsynth0001: 0 examples\n" in printed.getvalue()
    assert sorted(os.listdir(os.path.join(out, "trajectories"))) == \
        ["synth0002.npy", "synth0002_video_lengths.json"]
    with open(os.path.join(out, "labels.json")) as f, \
            open(os.path.join(trees["npy"], "labels.json")) as g:
        assert set(json.load(f)) == set(json.load(g))


def test_generated_dataset_loads_through_the_port(trees):
    """tests/test_datagen.py's pipeline test on the port's npy tree."""
    out = trees["npy"]
    with open(os.path.join(out, "labels.json")) as f:
        labels = json.load(f)
    assert len(labels) >= 3 and all(0 <= v < 70 for v in labels.values())
    with open(os.path.join(out, "split.json")) as f:
        split = json.load(f)
    assert set(split) == {"train", "val", "test"}
    assert sorted(sum(split.values(), [])) == sorted(labels)
    vocab = build_vocab(os.path.join(out, "questions"))
    assert 0 < len(vocab) < 134 + 1
    with open(os.path.join(out, "vocab.json")) as f:
        assert json.load(f) == vocab
    ds = tpipeline.VNQADataset(tpipeline.DataPaths(out), sorted(labels), labels,
                               deterministic=True)
    ex = ds.load_example(0)
    assert ex["question"].max() <= len(vocab)
    assert ex["video"].shape == (35, 160, 208, 3)


@pytest.mark.parametrize("tree, reference", [("port", "jax"), ("npy", "npy")])
def test_batch_loader_yields_the_jax_packages_first_batch(trees, tree, reference):
    """The port's loader on its tree against JAX's on its own mp4 tree, and
    both on the port's npy tree (the JAX package reads npy videos too)."""
    def first_batch(pipeline, root):
        with open(os.path.join(root, "labels.json")) as f:
            labels = json.load(f)
        ds = pipeline.VNQADataset(pipeline.DataPaths(root), sorted(labels), labels,
                                  deterministic=True)
        gen = pipeline.BatchLoader(ds, 2, shuffle=True, num_workers=2).epoch(0)
        try:
            return next(iter(gen))
        finally:
            gen.close()

    got = first_batch(tpipeline, trees[tree])
    want = first_batch(jpipeline, trees[reference])
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and np.array_equal(g, w), k
    assert want["video"].shape[0] == 2


def test_dataset_stats_prints_the_jax_packages_lines(trees):
    def printed(main, root):
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            main(["--data_dir", os.path.join(root, "questions"),
                  "--split_file", os.path.join(root, "split.json")])
        return buf.getvalue().splitlines()

    got = printed(tstats_cli.main, trees["port"])
    assert got == printed(jstats_cli.main, trees["jax"])
    with open(os.path.join(trees["port"], "labels.json")) as f:
        assert f">>> STATS: {len(json.load(f))} QUESTIONS," in "\n".join(got)


# ---------------------------------------------------------------- the House3D seam

def _seam(backend, mod_scene, mod_trajectory, mod_vision, mod_assets, mod_engine, tmp):
    rooms = backend.load_suncg_house(_FakeUtils(), HOUSE_ID, _OBJ_COLORS)
    graph = mod_scene.SceneGraph(rooms)
    colormap = mod_vision.load_semantic_colormap(mod_assets.COLORMAP_COARSE_CSV)
    observer = mod_trajectory.TrajectoryObserver(
        graph, backend.House3DRenderer(_FakeEnv(colormap)), rgb_to_obj=colormap,
        compute_seen_doors=True)
    coors = [(3.0, 1.2, 3.0, 0.0), (5.0, 1.2, 3.0, 90.0), (9.0, 1.2, 3.0, 0.0)]
    per_frame = observer.observe(coors, return_objects_in_frames=True)
    frames = observer.render_video(coors)
    engine = mod_engine.QuestionEngine(str(tmp), random.Random(0))
    example = engine.generate_for_trajectory(0, graph)
    with open(engine.dump_dataset(HOUSE_ID), "rb") as f:
        dumped = f.read()
    return {"rooms": [dataclasses.asdict(r) for r in rooms], "per_frame": per_frame,
            "objects": graph.get_all_objects(), "rooms_seen": graph.get_all_rooms(),
            "doors": observer.doors, "frames": frames, "example": example, "dumped": dumped}


def test_house3d_seam_matches_jax(fake_house3d, tmp_path, monkeypatch):  # noqa: F811
    with step_clock(monkeypatch):
        got = _seam(house3d_backend, scene, trajectory, vision, assets, tengine, tmp_path / "t")
    with step_clock(monkeypatch):
        want = _seam(jh3d, jscene, jtrajectory, jvision, jassets, jengine, tmp_path / "j")
    assert np.array_equal(got.pop("frames"), want.pop("frames"))
    assert got == want
    assert "bed" in got["per_frame"][0] and "sink" in got["per_frame"][2]
    assert got["doors"] and got["example"]["q_text"]
    assert {r["room_type"] for r in got["rooms_seen"]} == {"bedroom", "kitchen"}


def test_house3d_shipped_assets_load():
    colormap = vision.load_semantic_colormap(assets.COLORMAP_COARSE_CSV)
    assert colormap[(254, 255, 230)] == "bed" and len(colormap) == 94
    obj_colors = house3d_backend.load_obj_colors(assets.OBJECT_ID_TO_COLORS_NPY)
    assert obj_colors == jh3d.load_obj_colors(jassets.OBJECT_ID_TO_COLORS_NPY)
    assert len(obj_colors) > 2000


def test_house3d_renderer_requires_house3d():
    with pytest.raises(ImportError, match="House3D fork not installed"):
        house3d_backend.House3DRenderer(object())


@pytest.mark.parametrize("code", [0, 3])
def test_run_scn2scn_runs_the_binary_it_is_given(tmp_path, code):
    log = tmp_path / "args.txt"
    binary = tmp_path / "scn2scn"
    binary.write_text(f'#!/bin/sh\necho "$@" > {log}\nexit {code}\n')
    binary.chmod(binary.stat().st_mode | stat.S_IXUSR)
    house_json, house_obj = str(tmp_path / "house.json"), str(tmp_path / "house.obj")
    if code:
        with pytest.raises(subprocess.CalledProcessError):
            house3d_backend.run_scn2scn(str(binary), house_json, house_obj)
    else:
        house3d_backend.run_scn2scn(str(binary), house_json, house_obj)
    assert log.read_text().split() == [house_json, house_obj]
