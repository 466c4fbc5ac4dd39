"""Question generation: tag instantiation, functional-tree evaluation and
consistency checks.

Rebuild of QuestionGenerator (scripts/question_gen.py:26-1131) as an explicit
interpreter over ``datagen.templates`` + ``datagen.programs``:

- tags (<obj_type*>, <room_type*>, <attr*>, <color>, <rel>, <comp>, ...) are
  sampled from the observed scene with the reference's answer-leak
  restrictions (:545-660);
- branches pipe inputs through the op registry; set templates evaluate their
  per-element op list set_size times with indexed tags (:693-756);
- the validity checks are ported one-for-one: answer match (:1026-1027),
  ground-truth count consistency (:882-920), all-rooms-of-type-visited
  (:816-854), more-than-one-room-seen (:861-869), banned-object filtering
  (:927-981), rel-question room-location placement (:991-1006);
- generation runs under an optional wall-clock deadline instead of the
  reference's SIGALRM handler (scripts/engine.py:174-186) — same bound,
  thread-safe.

Randomness comes from an injected ``random.Random`` so generation is
reproducible.
"""

from __future__ import annotations

import re
import time

from videonavqa_tpu_torch.datagen import programs
from videonavqa_tpu_torch.datagen.ontology import (
    ALL_SIMPLE_ROOM_TYPES, BANNED_ENTROPY_SENSITIVE, BANNED_NEGATIVE_EXISTENCE,
    EXCLUDE_ROOMS, QUERY_OBJECTS,
)
from videonavqa_tpu_torch.datagen.programs import EvalContext, GenerationError, OPS
from videonavqa_tpu_torch.datagen.templates import (
    FINE_GRAINED_ROOM_COUNT_TEMPLATES, ItemType, SORTED_TEMPLATE_KEYS, TEMPLATES,
)
from videonavqa_tpu_torch.datagen.text import realize_question

TAG_TYPES = ("attr", "obj_type", "room_type", "color", "rel", "comp",
             "comp_rel", "comp_sup")


class GenerationTimeout(Exception):
    """Deadline exceeded while searching for a valid instantiation."""


def _to_python(value):
    """Normalize numpy scalars leaking in from bbox math (np.bool_/np.integer)
    so answers JSON-serialize and type checks see builtin bool/int."""
    import numpy as np

    if isinstance(value, np.bool_):
        return bool(value)
    if isinstance(value, np.integer):
        return int(value)
    return value


def _strip_pl(s):
    return s[:-3] if s.endswith("-pl") else s


def _strip_idx(s):
    return s.replace("{}", "")


def _strip_nums(s):
    return re.sub("[0-9]", "", s)


class QuestionGenerator:
    def __init__(self, scene, rng):
        """scene: SceneGraph-like query surface; rng: random.Random."""
        self.scene = scene
        self.rng = rng
        self.ctx = EvalContext(scene=scene)
        self.set_size = None
        self.tag_instantiations = {}

    # ------------------------------------------------------------------
    # Template-tree evaluation
    # ------------------------------------------------------------------
    def _resolve_op(self, op_string, branch_results):
        """'filter.obj_type.<obj_type1>' -> (op name, static args)."""
        tokens = op_string.split(".")
        args = list(tokens[1:-1]) if len(tokens) > 1 else []
        if len(tokens) > 1:
            last = tokens[-1]
            if "<" not in last:
                args.append(last)
            else:
                tag = re.findall("<(.*?)>", last)[0]
                if tag.startswith("tree_"):
                    args.append(branch_results[int(tag[5:])])
                else:
                    if tag.startswith("attr"):
                        args.append(self.tag_instantiations[tag]["type"])
                    args.append(self.tag_instantiations[tag]["value"])
        return tokens[0], args

    def _branch_inputs(self, spec, input_names, branch_results, *,
                       all_objects, all_rooms):
        inputs = []
        for name in input_names.split("|"):
            if name.startswith("inputs_"):
                item_type = spec["inputs"][int(name[-1])]
                if item_type in (ItemType.OBJECTS, ItemType.OBJECTS_REL):
                    inputs.append(self.house["objects_all" if all_objects else "objects"])
                elif all_rooms:
                    inputs.append(self.house["rooms_all"])
                else:
                    inputs.append(self.house["rooms"])
            elif name.startswith("tree_"):
                inputs.append(branch_results[int(name[5:])])
            else:
                tag = name[1:-1]
                inputs.append(self.tag_instantiations[tag]["value"])
        return inputs

    def _eval_set(self, fn_list, set_inputs):
        """One evaluation of the per-element op list per set member, with {}
        replaced by the member index (scripts/question_gen.py:693-708)."""
        results = []
        for i in range(self.set_size):
            prev = list(set_inputs)
            for op_string in fn_list:
                op_string = op_string.replace("{}", str(i + 1))
                name, args = self._resolve_op(op_string, [])
                prev = [OPS[name](self.ctx, *(args + prev))]
            results.append(prev[0])
        return results

    def _eval_tree(self, spec, *, all_objects=False, all_rooms=False):
        branch_results = []
        for branch in spec["tree"]:
            prev = self._branch_inputs(spec, branch[0], branch_results,
                                       all_objects=all_objects, all_rooms=all_rooms)
            for op_string in branch[1:]:
                if op_string == "iter_set":
                    prev = self._eval_set(spec["iter_set_fn_list"], prev)
                else:
                    name, args = self._resolve_op(op_string, branch_results)
                    prev = [OPS[name](self.ctx, *(args + prev))]
            branch_results.append(prev[0])
        return branch_results

    # ------------------------------------------------------------------
    # House info
    # ------------------------------------------------------------------
    def _generate_house_info(self, spec):
        """Scene views consumed by the tree (scripts/question_gen.py:762-792):
        rooms are restricted to those with at least one seen object; for
        relation templates, objects are the members of nearby pairs."""
        house = {"objects": self.scene.get_all_objects(), "rooms": [],
                 "objects_rel": []}
        if ItemType.ROOMS in spec["inputs"]:
            rooms = self.scene.get_all_rooms()
            seen_room_ids = {o["room_id"] for o in house["objects"]}
            house["rooms"] = [r for r in rooms if r["room_id"] in seen_room_ids]
        if ItemType.OBJECTS_REL in spec["inputs"]:
            pairs = self.scene.get_all_nearby_object_pairs()
            metas, seen_ids = [], set()
            for rel in ("on", "next_to"):
                for a, b, *_ in pairs[rel]:
                    for item in (a, b):
                        if id(item.meta) not in seen_ids:
                            seen_ids.add(id(item.meta))
                            metas.append(item.meta)
            house["objects"] = metas
            house["objects_rel"] = {
                rel: [(a.meta, b.meta) for a, b, *_ in pairs[rel]]
                for rel in ("on", "next_to")}
        self.house = house

    # ------------------------------------------------------------------
    # Tag instantiation (scripts/question_gen.py:545-660)
    # ------------------------------------------------------------------
    def _is_restricted_attr_type(self, attr_type):
        """Avoid leaking the queried attribute into the question (:545-547)."""
        return attr_type.split("_")[0] in self.q_template_string or (
            attr_type == "room_type" and "Where" in self.q_template_string)

    def _instantiate_tags(self):
        rng = self.rng
        tags = self.tag_instantiations

        obj_tags = [t for t in tags if "obj_type" in t]
        if obj_tags:
            obj_types = sorted({o["obj_type"] for o in self.house["objects"]})
            if self.q_template_string == "Is there set(<art> <attr{}> <obj_type{}>)?" \
                    and self.answer is False:
                obj_types = obj_types + rng.sample(sorted(QUERY_OBJECTS), len(obj_tags))
            if "<rel>" not in self.q_template_string and "door" in obj_types:
                obj_types.remove("door")
            if len(obj_tags) > len(obj_types):
                raise GenerationError("Not enough distinct object types!")
            for tag, val in zip(obj_tags, rng.sample(obj_types, len(obj_tags))):
                tags[tag]["value"] = val

        room_tags = [t for t in tags if "room_type" in t]
        if room_tags:
            if self.house["rooms"]:
                room_types = sorted({r["room_type"] for r in self.house["rooms"]
                                     if r["room_type"] not in EXCLUDE_ROOMS})
                if self.q_template_string in ("Is there <art> <room_type>?",
                                              "Is there set(<art> <room_type{}>)?") \
                        and self.answer is False:
                    # Sample negatives from simple room types absent from the
                    # whole house. (The reference compares simple-type strings
                    # against room *dicts*, scripts/question_gen.py:587-589, so
                    # it effectively samples from all simple types and relies
                    # on the answer check to reject hits — same outcome
                    # distribution, fewer wasted retries here.)
                    in_house = {s for r in self.scene.get_all_rooms(include_unseen_rooms=True)
                                for s in r["room_type"].split("|")}
                    absent = [t for t in ALL_SIMPLE_ROOM_TYPES if t not in in_house]
                    if len(absent) >= len(room_tags):
                        room_types = room_types + rng.sample(absent, len(room_tags))
            else:
                room_types = sorted({o["room_location"] for o in self.house["objects"]
                                     if o["room_location"] not in EXCLUDE_ROOMS})
            if len(room_tags) > len(room_types):
                raise GenerationError("Not enough distinct room types!")
            for tag, val in zip(room_tags, rng.sample(room_types, len(room_tags))):
                tags[tag]["value"] = val

        for tag in tags:
            if tag == "rel":
                tags[tag]["value"] = rng.choice(["on", "next_to"])
            elif tag == "comp":
                tags[tag]["value"] = rng.choice(["more", "fewer"])
            elif tag == "comp_rel":
                tags[tag]["value"] = "bigger"
            elif tag == "comp_sup":
                tags[tag]["value"] = "biggest"
            elif "color" in tag:
                colors = [o["color"] for o in self.house["objects"]
                          if o["color"] is not None]
                if not colors:
                    raise GenerationError("No colors available!")
                tags[tag]["value"] = rng.choice(colors)

        for tag in tags:
            if "attr" not in tag:
                continue
            tags[tag]["value"] = []
            tags[tag]["type"] = []
            for attr_type in ("color", "room_type"):
                if self._is_restricted_attr_type(attr_type):
                    continue
                # attribute values come from objects of the matching obj tag
                obj_tag = "obj_type" + "".join(re.findall("[0-9]", tag))
                attr_key = "room_location" if attr_type == "room_type" else attr_type
                if obj_tag in tags:
                    pool = [o[attr_key] for o in self.house["objects"]
                            if o[attr_key] is not None and
                            o["obj_type"] == tags[obj_tag]["value"]]
                else:
                    pool = [o[attr_key] for o in self.house["objects"]
                            if o[attr_key] is not None]
                if not pool:
                    raise GenerationError("No object attributes to choose from!")
                value = rng.choice(pool)
                # only sometimes attach the attribute, for variability (:650)
                if rng.choice([0, 1]):
                    if attr_key == "room_location" and value in EXCLUDE_ROOMS:
                        continue
                    tags[tag]["value"].append(value)
                    tags[tag]["type"].append(attr_key)

    # ------------------------------------------------------------------
    # Consistency checks (scripts/question_gen.py:795-981)
    # ------------------------------------------------------------------
    def _check_answer(self, result):
        return result == self.answer or isinstance(self.answer, str)

    def _ensure_attrs_not_ambiguous(self):
        """Attach 'everywhere' when only one side is room-qualified (:800-808)."""
        t = self.tag_instantiations
        if "room_location" in t["attr1"]["type"] and \
                "room_location" not in t["attr2"]["type"]:
            t["attr2"]["type"].append("room_location")
            t["attr2"]["value"].append("everywhere")
        elif "room_location" in t["attr2"]["type"] and \
                "room_location" not in t["attr1"]["type"]:
            t["attr1"]["type"].append("room_location")
            t["attr1"]["value"].append("everywhere")

    def _check_counts(self, spec, result):
        involves_counting = "all" in self.q_template_string or any(
            op in branch for branch in spec["tree"]
            for op in ("count", "count_unique"))
        if not involves_counting:
            return True
        if self.q_template_string.startswith("Are there") and \
                ItemType.OBJECTS in spec["inputs"]:
            self._ensure_attrs_not_ambiguous()
        for tag, inst in self.tag_instantiations.items():
            if "obj_type" in tag and "kitchen_cabinet" in inst["value"]:
                return False
        if "objects_all" not in self.house:
            self.house["objects_all"] = self.scene.get_all_objects(
                include_unseen_objects=True)
        try:
            full = self._eval_tree(spec, all_objects=True)
        except GenerationError:
            return False
        return full[-1] == result

    def _check_all_rooms_of_type_visited(self, spec, result):
        if self.q_template_string not in (
                "Are there <comp> <room_type1-pl> than <room_type2-pl>?",
                "How many <room_type-pl> are there?"):
            return True
        if "rooms_all" not in self.house:
            self.house["rooms_all"] = self.scene.get_all_rooms(include_unseen_rooms=True)
        for tag, inst in self.tag_instantiations.items():
            if "room_type" in tag:
                on_traj = OPS["filter"](self.ctx, "room_type", inst["value"],
                                        self.house["rooms"])
                in_house = OPS["filter"](self.ctx, "room_type", inst["value"],
                                         self.house["rooms_all"])
                if len(on_traj) != len(in_house):
                    return False
        try:
            full = self._eval_tree(spec, all_rooms=True)
        except GenerationError:
            return False
        return full[-1] == result

    def _check_more_rooms_seen(self):
        if self.q_template_string not in (
                "Are all <attr> <obj_type-pl> in the <room_type>?",
                "Are both the <attr1> <obj_type1> and the <attr2> <obj_type2> in the <room_type>?",
                "Are the <attr1> <obj_type1> and the <attr2> <obj_type2> in the same room?"):
            return True
        return len({o["room_id"] for o in self.house["objects"]}) > 1

    def _check_allowed_objects(self, result):
        """Entropy/negative-existence ban lists (:927-981)."""
        if self.q_template_string.startswith("Where "):
            assert isinstance(result, str)
        elif self.q_template_string in (
                "Are all <attr> <obj_type-pl> in the <room_type>?",
                "Are both the <attr1> <obj_type1> and the <attr2> <obj_type2> in the <room_type>?",
                "Is there set(<art> <attr{}> <obj_type{}>) in the <room_type>?",
                "Is there set(<art> <attr{}> <obj_type{}>)?",
                "Are the <attr1> <obj_type1> and the <attr2> <obj_type2> in the same room?",
                "Is there a room that has set(<art> <attr{}> <obj_type{}>)?"):
            assert isinstance(result, bool)
        else:
            return True

        for tag, inst in self.tag_instantiations.items():
            if "attr" in tag:
                continue
            value = inst["value"]
            if value in BANNED_ENTROPY_SENSITIVE:
                return False
            if result is False and value in BANNED_NEGATIVE_EXISTENCE and \
                    "room_type" in self.tag_instantiations:
                forbidden = BANNED_NEGATIVE_EXISTENCE[value]
                simple_types = self.tag_instantiations["room_type"]["value"].split("|")
                if not any(s not in forbidden for s in simple_types):
                    return False
        return True

    def _position_room_location_for_rel(self):
        """Keep the room qualifier only on the second object (:991-1006)."""
        t = self.tag_instantiations
        a1, a2 = t["attr1"], t["attr2"]
        if "room_location" in a1["type"]:
            idx = a1["type"].index("room_location")
            value = a1["value"][idx]
            if "room_location" not in a2["type"]:
                a2["type"].append("room_location")
                a2["value"].append(value)
            a1["type"].pop(idx)
            a1["value"].pop(idx)

    # ------------------------------------------------------------------
    # Entry point
    # ------------------------------------------------------------------
    def generate_example(self, question_id, answer, *, deadline=None):
        """Generate (q_text, q_answer) for the given template id, targeting the
        given answer ('<query>:...' strings accept any answer). Raises
        GenerationTimeout past ``deadline`` (time.perf_counter seconds)."""
        self.q_template_string = SORTED_TEMPLATE_KEYS[question_id]
        spec = TEMPLATES[self.q_template_string]
        self.ctx.fine_grained_room_counts = (
            self.q_template_string in FINE_GRAINED_ROOM_COUNT_TEMPLATES)
        self.answer = answer

        # tags needing instantiation
        self.set_size = self.rng.choice(spec["set_size"]) if "set_size" in spec else None
        tags = []
        for tag in re.findall("<(.*?)>", self.q_template_string):
            if "{}" in tag:
                tags += [tag.replace("{}", str(i + 1)) for i in range(self.set_size)]
            else:
                tags.append(tag)
        self.tag_instantiations = {}
        for tag in tags:
            base = _strip_nums(_strip_pl(_strip_idx(tag)))
            if base in TAG_TYPES:
                self.tag_instantiations[_strip_pl(tag)] = {"value": None, "type": base}

        self._generate_house_info(spec)

        while True:
            if deadline is not None and time.perf_counter() > deadline:
                raise GenerationTimeout(self.q_template_string)
            try:
                self._instantiate_tags()
                results = self._eval_tree(spec)
            except GenerationError:
                continue
            result = _to_python(results[-1])
            if self._check_answer(result) and \
               self._check_counts(spec, result) and \
               self._check_all_rooms_of_type_visited(spec, result) and \
               self._check_more_rooms_seen() and \
               self._check_allowed_objects(result):
                break

        self.answer = result
        if "<rel>" in self.q_template_string:
            self._position_room_location_for_rel()
        q_text = realize_question(self.q_template_string, self.tag_instantiations,
                                  set_size=self.set_size)
        return q_text, self.answer
