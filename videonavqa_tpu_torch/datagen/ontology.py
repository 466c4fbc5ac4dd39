"""The VideoNavQA ontology: vocabularies, ban lists and the answer-class map
(a copy of the JAX package's datagen/ontology.py).

These are the benchmark's ground-truth data tables; their values must match the
reference exactly for label/answer compatibility:
- queryable object classes             scripts/constants.py:2-35
- excluded room types                  scripts/constants.py:37-40
- entropy-banned objects               scripts/constants.py:52-60
- banned obj/room negative-existence   scripts/constants.py:62-76
- simple room types                    scripts/constants.py:78-98
- 70-class answer map                  scripts/write_labels.py:14-85
- question-category map                eval/results_analysis.py:17-26
"""

# The 32 object classes questions may ask about (from House3D's coarse classes).
QUERY_OBJECTS = frozenset({
    "bathtub", "bed", "chair", "clock", "computer", "curtain", "desk", "door",
    "dresser", "fan", "gym_equipment", "hanging_kitchen_cabinet", "heater",
    "kitchen_cabinet", "mirror", "ottoman", "pillow", "rug", "sofa", "shoes",
    "shower", "sink", "stand", "switch", "table", "television", "toilet",
    "trash_can", "tv_stand", "vase", "vehicle", "wardrobe_cabinet",
})

# Room types never asked about.
EXCLUDE_ROOMS = frozenset({"room", ""})

# Objects with one overwhelmingly likely location — asking "where"/"are all in
# the X" about them leaks the answer.
BANNED_ENTROPY_SENSITIVE = frozenset({
    "bathtub", "bed", "hanging_kitchen_cabinet", "kitchen_cabinet", "shower",
    "toilet", "vehicle",
})

# For negative-existence questions: object -> implausible room types.
BANNED_NEGATIVE_EXISTENCE = {
    "computer": ["balcony", "bathroom", "boiler_room", "garage", "loggia",
                 "terrace", "wardrobe"],
    "desk": ["bathroom", "wardrobe"],
    "dresser": ["balcony", "bathroom", "boiler_room", "garage", "gym",
                "kitchen", "loggia", "terrace"],
    "gym_equipment": ["bathroom", "dining_room"],
    "ottoman": ["garage"],
    "pillow": ["bathroom", "boiler_room", "garage"],
    "sofa": ["bathroom", "garage"],
    "sink": ["balcony", "bedroom", "child_room", "dining_room", "entryway",
             "hall", "hallway", "living_room", "lobby", "loggia", "office",
             "terrace", "wardrobe"],
    "television": ["bathroom", "boiler_room", "wardrobe"],
    "tv_stand": ["bathroom", "boiler_room", "wardrobe"],
    "wardrobe_cabinet": ["balcony", "kitchen", "loggia", "terrace"],
}

ALL_SIMPLE_ROOM_TYPES = [
    "balcony", "bathroom", "bedroom", "boiler_room", "child_room",
    "dining_room", "entryway", "garage", "gym", "hall", "hallway", "kitchen",
    "living_room", "lobby", "loggia", "office", "storage", "terrace",
    "wardrobe",
]

# The canonical answer -> class-index map ("label_to_class_v3"). Keys are the
# str() of the raw answer (counts, bools, colors, object and room types).
ANSWER_VOCAB = {
    "1": 0, "10": 1, "2": 2, "3": 3, "4": 4, "5": 5, "6": 6, "7": 7, "8": 8,
    "9": 9, "False": 10, "True": 11, "bathroom": 12, "bathroom|bedroom": 13,
    "bathtub": 14, "bed": 15, "bedroom": 16, "black": 17, "blue": 18,
    "brown": 19, "chair": 20, "child_room": 21, "clock": 22, "computer": 23,
    "curtain": 24, "desk": 25, "dining_room": 26, "dining_room|kitchen": 27,
    "dining_room|kitchen|living_room": 28,
    "dining_room|kitchen|living_room|office": 29, "dining_room|living_room": 30,
    "dining_room|living_room|office": 31, "door": 32, "dresser": 33,
    "entryway": 34, "green": 35, "grey": 36, "gym": 37, "gym_equipment": 38,
    "gym|living_room": 39, "gym|living_room|office": 40, "hallway": 41,
    "hanging_kitchen_cabinet": 42, "heater": 43, "kitchen": 44,
    "kitchen_cabinet": 45, "kitchen|living_room": 46, "living_room": 47,
    "living_room|office": 48, "maroon": 49, "mirror": 50, "office": 51,
    "ottoman": 52, "rug": 53, "shower": 54, "sink": 55, "sofa": 56,
    "stand": 57, "switch": 58, "table": 59, "tan": 60, "teal": 61,
    "television": 62, "toilet": 63, "tv_stand": 64, "vase": 65, "vehicle": 66,
    "wardrobe": 67, "wardrobe_cabinet": 68, "white": 69,
}

# Room-type renames applied when building room descriptions
# (scripts/trajectory_gen.py:194-208).
ROOM_TYPE_RENAMES = {"toilet": "bathroom", "guest_room": "bedroom"}


def normalize_room_types(types):
    """Apply renames, dedupe, and sort — a composite room type is the '|'-join
    of its sorted simple types (scripts/trajectory_gen.py:216-223)."""
    out = []
    for t in types:
        t = ROOM_TYPE_RENAMES.get(t, t)
        if t not in out:
            out.append(t)
    return sorted(out)
