"""Offline dataset-generation tooling (the reference's scripts/ layer, L1-L3):
a copy of the JAX package's datagen/, all numpy and scipy, no torch:

- ``ontology``   — object/room vocabularies, banned lists, the 70-class answer
                   map (scripts/constants.py, scripts/write_labels.py).
- ``geometry``   — bbox math, containment, closest-distance, nearby-pair
                   relations (the HouseParse surface the reference imports from
                   the EmbodiedQA fork).
- ``scene``      — the ground-truth scene-graph data model (rooms, objects,
                   visit/seen state) built by the trajectory layer and consumed
                   by question generation.
- ``vision``     — semantic/depth frame processing: connected components,
                   per-type counts and approximate depths
                   (scripts/trajectory_gen.py:614-699).
- ``renderer``   — the pluggable renderer interface; House3D stays an external
                   optional backend, and a SyntheticRenderer draws boxy houses
                   so the whole pipeline runs end-to-end hermetically.
- ``trajectory`` — trajectory observation: look-around insertion, room visits,
                   depth-matching seen objects and doors
                   (scripts/trajectory_gen.py:95-557).
- ``programs``   — the functional-program op library
                   (scripts/question_gen.py:335-519) as a registry of pure
                   functions (no eval()).
- ``templates``  — the 29 question templates (scripts/question_gen.py:31-308).
- ``generator``  — tag instantiation + tree evaluation + consistency checks.
- ``text``       — English question realization (scripts/question_build.py).
- ``engine``     — answer-balancing generation engine (scripts/engine.py) with
                   deadline-based time budgets instead of SIGALRM.
- ``encode``     — tokenization/vocab/npy encoding (scripts/encode_questions.py).
- ``labels``     — labels.json / q_ids.json writer (scripts/write_labels.py).
- ``split``      — train/val/test split builder
                   (scripts/stats_for_generated_questions.py:39-63).
- ``stats``      — per-template distribution stats.
"""

from videonavqa_tpu_torch.datagen.ontology import (  # noqa: F401
    ANSWER_VOCAB, ALL_SIMPLE_ROOM_TYPES, BANNED_ENTROPY_SENSITIVE,
    BANNED_NEGATIVE_EXISTENCE, EXCLUDE_ROOMS, QUERY_OBJECTS,
)
