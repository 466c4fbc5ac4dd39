"""The 29 VideoNavQA question templates.

Template text and functional-program trees are the benchmark's specification
data (scripts/question_gen.py:31-308): each template maps to a list of
branches; a branch names its inputs (seen objects / rooms / relation pairs or
earlier branch results) and pipes them through dotted ops from
``datagen.programs``. Question ids are indices into the alphabetically sorted
template keys (scripts/question_gen.py:1013-1018).

Set templates additionally carry a per-element op list evaluated once per set
member with indexed tags, and draw a set size from {2, 3}
(scripts/question_gen.py:23,154-201).
"""

from __future__ import annotations

import enum


class ItemType(enum.Enum):
    ROOMS = 1
    OBJECTS = 2
    OBJECTS_REL = 3


SET_SIZES = [2, 3]

TEMPLATES = {
    "Are the <attr1> <obj_type1> and the <attr2> <obj_type2> the same color?": {
        "inputs": [ItemType.OBJECTS],
        "tree": [
            ["inputs_0", "filter.obj_type.<obj_type1>", "filter.<attr1>", "unique", "get_attr.color"],
            ["inputs_0", "filter.obj_type.<obj_type2>", "filter.<attr2>", "unique", "get_attr.color"],
            ["tree_0|tree_1", "equal"],
        ],
        "ans_type": bool,
    },
    "Are both the <attr1> <obj_type1> and the <attr2> <obj_type2> <color>?": {
        "inputs": [ItemType.OBJECTS],
        "tree": [
            ["inputs_0", "filter.obj_type.<obj_type1>", "filter.<attr1>", "unique", "get_attr.color"],
            ["tree_0|<color>", "equal"],
            ["inputs_0", "filter.obj_type.<obj_type2>", "filter.<attr2>", "unique", "get_attr.color"],
            ["tree_2|<color>", "equal"],
            ["tree_1|tree_3", "logical_and"],
        ],
        "ans_type": bool,
    },
    "Are all <attr> <obj_type-pl> <color>?": {
        "inputs": [ItemType.OBJECTS],
        "tree": [
            ["inputs_0", "filter.obj_type.<obj_type>", "filter.<attr>", "continue_if_non_empty", "get_attr.color"],
            ["tree_0|<color>", "equal_set"],
        ],
        "ans_type": bool,
    },
    "Is the <attr1> thing <rel> the <attr2> <obj_type2> <art> <obj_type1>?": {
        "inputs": [ItemType.OBJECTS_REL],
        "tree": [
            ["inputs_0", "filter.obj_type.<obj_type2>", "filter.<attr2>", "unique", "get_rel_objects.<rel>",
             "filter.<attr1>", "unique", "get_attr.obj_type"],
            ["tree_0|<obj_type1>", "equal"],
        ],
        "ans_type": bool,
    },
    "Are all <attr> things <obj_type-pl>?": {
        "inputs": [ItemType.OBJECTS],
        "tree": [
            ["inputs_0", "filter.<attr>", "continue_if_non_empty", "get_attr.obj_type"],
            ["tree_0|<obj_type>", "equal_set"],
        ],
        "ans_type": bool,
    },
    "Are both the <attr1> <obj_type1> and the <attr2> <obj_type2> in the <room_type>?": {
        "inputs": [ItemType.ROOMS, ItemType.OBJECTS],
        "tree": [
            ["inputs_0", "filter_unwanted_rooms", "filter.room_type.<room_type>", "unique", "get_attr.room_type"],
            ["inputs_1", "filter.obj_type.<obj_type1>", "filter.<attr1>", "unique", "get_attr.room_location"],
            ["tree_0|tree_1", "equal"],
            ["inputs_1", "filter.obj_type.<obj_type2>", "filter.<attr2>", "unique", "get_attr.room_location"],
            ["tree_0|tree_3", "equal"],
            ["tree_2|tree_4", "logical_and"],
        ],
        "ans_type": bool,
    },
    "Are all <attr> <obj_type-pl> in the <room_type>?": {
        "inputs": [ItemType.ROOMS, ItemType.OBJECTS],
        "tree": [
            ["inputs_0", "filter_unwanted_rooms", "filter.room_type.<room_type>", "unique", "get_attr.room_type"],
            ["inputs_1", "filter.obj_type.<obj_type>", "filter.<attr>", "continue_if_non_empty", "get_attr.room_location"],
            ["tree_1|tree_0", "equal_set"],
        ],
        "ans_type": bool,
    },
    "Is the <attr1> <obj_type> <comp_rel> than the <attr2> one?": {
        "inputs": [ItemType.OBJECTS],
        "tree": [
            ["inputs_0", "filter.obj_type.<obj_type>", "filter.<attr1>", "unique"],
            ["inputs_0", "filter.obj_type.<obj_type>", "filter.<attr2>", "unique"],
            ["tree_0|tree_1", "continue_if_distinct"],
            ["tree_0|tree_1", "comp_rel"],
        ],
        "ans_type": bool,
    },
    "Is the <room_type1> <comp_rel> than the <room_type2>?": {
        "inputs": [ItemType.ROOMS],
        "tree": [
            ["inputs_0", "filter_unwanted_rooms", "filter.room_type.<room_type1>", "unique"],
            ["inputs_0", "filter_unwanted_rooms", "filter.room_type.<room_type2>", "unique"],
            ["tree_0|tree_1", "comp_rel"],
        ],
        "ans_type": bool,
    },
    "Are there as many <attr1> <obj_type1-pl> as there are <attr2> <obj_type2-pl>?": {
        "inputs": [ItemType.OBJECTS],
        "tree": [
            ["inputs_0", "filter.obj_type.<obj_type1>", "filter.<attr1>", "count_exists"],
            ["inputs_0", "filter.obj_type.<obj_type2>", "filter.<attr2>", "count_exists"],
            ["tree_0|tree_1", "equal"],
        ],
        "ans_type": bool,
    },
    "Are there <comp> <attr1> <obj_type1-pl> than <attr2> <obj_type2-pl>?": {
        "inputs": [ItemType.OBJECTS],
        "tree": [
            ["inputs_0", "filter.obj_type.<obj_type1>", "filter.<attr1>", "count_exists"],
            ["inputs_0", "filter.obj_type.<obj_type2>", "filter.<attr2>", "count_exists"],
            ["tree_0|tree_1", "comp.<comp>"],
        ],
        "ans_type": bool,
    },
    "Is there <art> <attr> <obj_type>?": {
        "inputs": [ItemType.OBJECTS],
        "tree": [
            ["inputs_0", "filter.obj_type.<obj_type>", "filter.<attr>", "exists"],
        ],
        "ans_type": bool,
    },
    "Is there set(<art> <attr{}> <obj_type{}>)?": {
        "inputs": [ItemType.OBJECTS],
        "iter_set_fn_list": ["filter.obj_type.<obj_type{}>", "filter.<attr{}>"],
        "set_size": SET_SIZES,
        "tree": [
            ["inputs_0", "iter_set", "exists_set"],
        ],
        "ans_type": bool,
    },
    "Is there set(<art> <attr{}> <obj_type{}>) in the <room_type>?": {
        "inputs": [ItemType.ROOMS, ItemType.OBJECTS],
        "iter_set_fn_list": ["filter.obj_type.<obj_type{}>", "filter.<attr{}>",
                             "continue_if_non_empty", "get_attr.room_location"],
        "set_size": SET_SIZES,
        "tree": [
            ["inputs_0", "filter_unwanted_rooms", "filter.room_type.<room_type>", "unique", "get_attr.room_type"],
            ["inputs_1", "iter_set", "flatten_set"],
            ["tree_1|tree_0", "equal_set"],
        ],
        "ans_type": bool,
    },
    "Is there <art> <room_type>?": {
        "inputs": [ItemType.ROOMS],
        "tree": [
            ["inputs_0", "filter_unwanted_rooms", "filter.room_type.<room_type>", "exists"],
        ],
        "ans_type": bool,
    },
    "Is there a room that has set(<art> <attr{}> <obj_type{}>)?": {
        "inputs": [ItemType.OBJECTS],
        "iter_set_fn_list": ["filter.obj_type.<obj_type{}>", "filter.<attr{}>",
                             "continue_if_non_empty", "get_attr.room_id"],
        "set_size": SET_SIZES,
        "tree": [
            ["inputs_0", "iter_set", "intersect", "exists"],
        ],
        "ans_type": bool,
    },
    "Is there set(<art> <room_type{}>)?": {
        "inputs": [ItemType.ROOMS],
        "iter_set_fn_list": ["filter.room_type.<room_type{}>"],
        "set_size": SET_SIZES,
        "tree": [
            ["inputs_0", "filter_unwanted_rooms", "iter_set", "exists_set"],
        ],
        "ans_type": bool,
    },
    "How many <obj_type-pl> are <attr>?": {
        "inputs": [ItemType.OBJECTS],
        "tree": [
            ["inputs_0", "filter.obj_type.<obj_type>", "filter.<attr>", "count"],
        ],
        "ans_type": int,
    },
    "How many <attr> <obj_type-pl> are in the <room_type>?": {
        "inputs": [ItemType.OBJECTS, ItemType.ROOMS],
        "tree": [
            ["inputs_1", "filter_unwanted_rooms", "filter.room_type.<room_type>", "get_attr.room_id", "unique"],
            ["inputs_0", "filter.obj_type.<obj_type>", "filter.<attr>", "filter.room_location.<room_type>", "count"],
        ],
        "ans_type": int,
    },
    "How many <attr1> <obj_type1-pl> are in the room containing the <attr2> <obj_type2>?": {
        "inputs": [ItemType.OBJECTS],
        "tree": [
            ["inputs_0", "filter.obj_type.<obj_type1>", "filter.<attr1>"],
            ["inputs_0", "filter.obj_type.<obj_type2>", "filter.<attr2>", "unique", "get_attr.room_id"],
            ["tree_0", "filter.room_id.<tree_1>", "count"],
        ],
        "ans_type": int,
    },
    "How many <room_type-pl> are there?": {
        "inputs": [ItemType.ROOMS],
        "tree": [
            ["inputs_0", "filter_unwanted_rooms", "filter.room_type.<room_type>", "count"],
        ],
        "ans_type": int,
    },
    "How many rooms have <attr> <obj_type-pl>?": {
        "inputs": [ItemType.OBJECTS],
        "tree": [
            ["inputs_0", "filter.obj_type.<obj_type>", "filter.<attr>", "get_attr.room_id", "count_unique"],
        ],
        "ans_type": int,
    },
    "What color is the <attr> <obj_type>?": {
        "inputs": [ItemType.OBJECTS],
        "tree": [
            ["inputs_0", "filter.obj_type.<obj_type>", "filter.<attr>", "unique", "get_attr.color"],
        ],
        "ans_type": "color",
    },
    "What color is the <attr1> <obj_type1> <rel> the <attr2> <obj_type2>?": {
        "inputs": [ItemType.OBJECTS_REL],
        "tree": [
            ["inputs_0", "filter.obj_type.<obj_type2>", "filter.<attr2>", "unique", "get_rel_objects.<rel>",
             "filter.obj_type.<obj_type1>", "filter.<attr1>", "unique", "get_attr.color"],
        ],
        "ans_type": "color",
    },
    "What is the <attr> thing?": {
        "inputs": [ItemType.OBJECTS],
        "tree": [
            ["inputs_0", "filter.<attr>", "unique", "get_attr.obj_type"],
        ],
        "ans_type": "obj_type",
    },
    "What is the <attr1> thing <rel> the <attr2> <obj_type2>?": {
        "inputs": [ItemType.OBJECTS_REL],
        "tree": [
            ["inputs_0", "filter.obj_type.<obj_type2>", "filter.<attr2>", "unique", "get_rel_objects.<rel>",
             "filter.<attr1>", "unique", "get_attr.obj_type"],
        ],
        "ans_type": "obj_type",
    },
    "Where is the <attr> <obj_type>?": {
        "inputs": [ItemType.OBJECTS],
        "tree": [
            ["inputs_0", "filter.obj_type.<obj_type>", "filter.<attr>", "unique", "get_attr.room_location", "room_if_allowed"],
        ],
        "ans_type": "room_location",
    },
    "Where is the <attr1> <obj_type1> <rel> the <attr2> <obj_type2>?": {
        "inputs": [ItemType.OBJECTS_REL],
        "tree": [
            ["inputs_0", "filter.obj_type.<obj_type2>", "filter.<attr2>", "unique", "get_rel_objects.<rel>",
             "filter.obj_type.<obj_type1>", "filter.<attr1>", "unique", "get_attr.room_location", "room_if_allowed"],
        ],
        "ans_type": "room_location",
    },
    "Where are the set(<attr{}> <obj_type{}>)?": {
        "inputs": [ItemType.OBJECTS],
        "iter_set_fn_list": ["filter.obj_type.<obj_type{}>", "filter.<attr{}>",
                             "unique", "get_attr.room_id"],
        "set_size": SET_SIZES,
        "tree": [
            ["inputs_0", "iter_set", "unique_set", "strip_nums", "room_if_allowed"],
        ],
        "ans_type": "room_location",
    },
}

#: q_id <-> template text (alphabetical order, scripts/question_gen.py:1013-1018)
SORTED_TEMPLATE_KEYS = sorted(TEMPLATES)

#: Templates that use fine-grained composite-room-type counting
#: (scripts/question_gen.py:529-537; one listed key is not an actual template —
#: preserved verbatim as it is simply never matched).
FINE_GRAINED_ROOM_COUNT_TEMPLATES = frozenset({
    "Are there <comp> <room_type1-pl> than <room_type2-pl>?",
    "How many <room_type-pl> are there?",
    "Is there <art> <room_type>?",
    "Is there set(<art> <room_type{}>)?",
})

NUM_TEMPLATES = len(TEMPLATES)
assert NUM_TEMPLATES == 29
