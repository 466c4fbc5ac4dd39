"""The functional-program op library for question templates.

Each of the reference's template-tree operations
(scripts/question_gen.py:335-519) as a pure function in an explicit registry —
dispatch is by name lookup, not eval('self.' + fn). Ops raise
GenerationError to signal an unsatisfiable instantiation; the generator
catches it and re-instantiates.

Ops that need world state (get_rel_objects, filter's fine-grained room mode)
receive an EvalContext.
"""

from __future__ import annotations

import dataclasses
import re

from videonavqa_tpu_torch.datagen import geometry
from videonavqa_tpu_torch.datagen.ontology import EXCLUDE_ROOMS


class GenerationError(Exception):
    """A template could not be satisfied with the current instantiation
    (QuestionGenerationError, scripts/question_gen.py:12-14)."""


@dataclasses.dataclass
class EvalContext:
    scene: object = None                    # SceneGraph for get_rel_objects
    fine_grained_room_counts: bool = False  # composite-room-type filter mode


OPS = {}


def op(fn):
    OPS[fn.__name__] = fn
    return fn


@op
def equal(ctx, v1, v2):
    return v1 == v2


@op
def equal_set(ctx, values, v):
    return len(values) > 0 and all(v == x for x in values)


@op
def flatten_set(ctx, *sets):
    out = []
    for s in sets:
        out += s
    return out


@op
def continue_if_distinct(ctx, obj1, obj2):
    if obj1 == obj2:
        raise GenerationError("both candidates resolve to the same object")
    return [obj1, obj2]


@op
def continue_if_non_empty(ctx, values):
    if len(values) > 0:
        return values
    raise GenerationError("empty set: cannot continue this program")


@op
def exists(ctx, values):
    return len(values) > 0


@op
def exists_set(ctx, *sets):
    assert sets, "exists_set needs at least one input set"
    return all(len(s) > 0 for s in sets)


@op
def unique(ctx, values):
    if len(values) == 0 or not all(values[0] == x for x in values):
        raise GenerationError("set does not reduce to a single value")
    return values[0]


@op
def unique_set(ctx, *values):
    return unique(ctx, values)


@op
def intersect(ctx, *sets):
    assert len(sets) > 1, "intersect needs >= 2 input sets"
    result = set(sets[0])
    for s in sets[1:]:
        result &= set(s)
    return list(result)


@op
def count(ctx, values):
    return len(values)


@op
def count_exists(ctx, values):
    if len(values) == 0:
        raise GenerationError("count_exists over an empty set")
    return len(values)


@op
def count_unique(ctx, values):
    return len(set(values))


@op
def comp(ctx, op_name, v1, v2):
    assert op_name in ("more", "fewer"), "comparison operator must be more/fewer"
    return v1 > v2 if op_name == "more" else v1 < v2


@op
def comp_rel(ctx, b1, b2):
    assert "bbox" in b1 and "bbox" in b2, "comp_rel arguments must carry a bbox"
    return geometry.bbox_larger(b1["bbox"], b2["bbox"], 0.25)


@op
def comp_sup(ctx, items):
    if len(items) < 2:
        raise GenerationError("size comparison needs >= 2 items")
    biggest = items[0]
    for item in items[1:]:
        if geometry.bbox_larger(item["bbox"], biggest["bbox"], 0.1):
            biggest = item
    return biggest


@op
def get_attr(ctx, attr, item):
    items = item if isinstance(item, list) else [item]
    for x in items:
        if attr not in x or x[attr] is None:
            raise GenerationError("attribute %r missing or None on item" % attr)
    values = [x[attr] for x in items]
    return values if isinstance(item, list) else values[0]


@op
def filter(ctx, attr_name, attr_value, values):  # noqa: A001 - reference name
    # Composite room types: 'living_room|kitchen' counts as a 'living_room'
    # and a 'kitchen' for the room-count templates (scripts/question_gen.py:449-456).
    if ctx.fine_grained_room_counts and attr_name == "room_type":
        simple = attr_value.split("|")
        return [x for x in values
                if all(s in x["room_type"] for s in simple)]
    if attr_name in (None, []):
        return values
    if isinstance(attr_name, list):
        res = values
        for name, val in zip(attr_name, attr_value):
            res = [x for x in res if x[name] == val]
        return res
    return [x for x in values if x[attr_name] == attr_value]


@op
def filter_unwanted_rooms(ctx, values):
    for x in values:
        assert "room_type" in x, "item lacks a room_type attribute"
    return [x for x in values if x["room_type"] not in EXCLUDE_ROOMS]


@op
def get_rel_objects(ctx, rel, obj):
    all_pairs = ctx.scene.get_all_nearby_object_pairs()[rel]
    if not all_pairs:
        raise GenerationError("scene has no %r-related object pairs" % rel)
    rel_objects = [pair[0].meta for pair in all_pairs if pair[1].meta == obj]
    if not rel_objects:
        raise GenerationError(
            "no %r-related pairs touch object %s" % (rel, obj["node"]))
    return rel_objects


@op
def logical_and(ctx, v1, v2):
    return v1 and v2


@op
def strip_nums(ctx, string):
    return re.sub("[0-9]", "", string)


@op
def room_if_allowed(ctx, string):
    if string in EXCLUDE_ROOMS:
        raise GenerationError("room type is on the exclusion list")
    return string
