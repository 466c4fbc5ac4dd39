"""Answer-balancing question-generation engine.

Rebuild of QuestionEngine (scripts/engine.py): per trajectory it picks a
template (retry queue first, else random), targets the currently
under-represented answer (bool: minority side; count: ascending-frequency
order of 1..10), bounds each attempt with a wall-clock deadline (the
reference's SIGALRM timers, scripts/engine.py:174-186 — 0.5 s, 0.8 s for
relation templates), dedupes (text, answer) pairs, and dumps one JSON per
house keyed by trajectory id.

Relation templates get the longer budget by inspecting their trees for
get_rel_objects — the reference hardcodes ids [15, 24, 26, 29], which includes
the out-of-range id 29 and misses none otherwise (SURVEY §8.10).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from videonavqa_tpu_torch.datagen.generator import GenerationTimeout, QuestionGenerator
from videonavqa_tpu_torch.datagen.templates import SORTED_TEMPLATE_KEYS, TEMPLATES

TIMEOUT = 0.5
TIMEOUT_REL = 0.8
MAX_COUNT_ANSWER = 10

REL_TEMPLATE_IDS = frozenset(
    i for i, key in enumerate(SORTED_TEMPLATE_KEYS)
    if any("get_rel_objects" in op for branch in TEMPLATES[key]["tree"] for op in branch))


class QuestionEngine:
    def __init__(self, save_dir, rng):
        self.save_dir = save_dir
        self.rng = rng

        self.question_set = {}
        for key in SORTED_TEMPLATE_KEYS:
            ans_type = TEMPLATES[key]["ans_type"]
            dist = {}
            if ans_type is bool:
                dist = {False: 0, True: 0}
            elif ans_type is int:
                dist = {i: 0 for i in range(1, MAX_COUNT_ANSWER + 1)}
            self.question_set[key] = {
                "ans_type": ans_type, "generated_count": 0, "ans_distribution": dist}

        self.generate_later_queue = []
        self.dataset = {}
        self.generated_pairs = set()

    # ------------------------------------------------------------------
    def _required_answers(self, key):
        """Prefer under-represented answers (scripts/engine.py:148-168)."""
        info = self.question_set[key]
        dist = info["ans_distribution"]
        if info["ans_type"] is bool:
            return [False] if dist[False] < dist[True] else [True]
        if info["ans_type"] is int:
            counts = [dist[i] for i in range(1, MAX_COUNT_ANSWER + 1)]
            return [int(i) + 1 for i in np.argsort(np.array(counts, dtype=np.int64),
                                                   kind="stable")]
        return ["<query>:" + str(info["ans_type"])]

    def _write_example(self, traj_id, q_id, q_text, q_answer, key, tag_instantiations):
        pair = q_text + "|" + str(q_answer)
        if pair in self.generated_pairs:
            return False
        self.generated_pairs.add(pair)
        dist = self.question_set[key]["ans_distribution"]
        dist[q_answer] = dist.get(q_answer, 0) + 1
        self.question_set[key]["generated_count"] += 1
        self.dataset[traj_id] = {
            "q_id": q_id,
            "tag_instantiation": tag_instantiations,
            "q_text": q_text,
            "q_ans": q_answer,
        }
        return True

    # ------------------------------------------------------------------
    def generate_for_trajectory(self, traj_id, scene, *, verbose=False):
        """Generate one example for an observed trajectory's scene graph.
        Returns the example dict or None if every template failed."""
        generator = QuestionGenerator(scene, self.rng)
        q_ids_attempted = set()
        n = len(SORTED_TEMPLATE_KEYS)

        while True:
            if self.generate_later_queue and self.generate_later_queue[0][1] != traj_id:
                q_id, _ = self.generate_later_queue.pop(0)
            else:
                q_id = self.rng.randint(0, n - 1)
            key = SORTED_TEMPLATE_KEYS[q_id]
            q_ids_attempted.add(q_id)

            timeout = TIMEOUT_REL if q_id in REL_TEMPLATE_IDS else TIMEOUT
            for required in self._required_answers(key):
                try:
                    q_text, q_answer = generator.generate_example(
                        q_id, required, deadline=time.perf_counter() + timeout)
                except GenerationTimeout:
                    continue
                if not isinstance(required, str):
                    assert q_answer == required
                if verbose:
                    print("### Success!", q_text, q_answer)
                self._write_example(traj_id, q_id, q_text, q_answer, key,
                                    generator.tag_instantiations)
                return self.dataset.get(traj_id)

            if (q_id, traj_id) not in self.generate_later_queue:
                self.generate_later_queue.append((q_id, traj_id))
            if q_ids_attempted == set(range(n)):
                if verbose:
                    print("!!! Could not generate a question for trajectory", traj_id)
                return None

    def dump_dataset(self, house_id):
        """Write per-house question JSON (scripts/engine.py:100-112)."""
        if not self.dataset:
            return None
        os.makedirs(self.save_dir, exist_ok=True)
        path = os.path.join(self.save_dir, house_id + ".json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.dataset, f)
        os.replace(tmp, path)  # atomic: resume never sees partial files
        self.dataset = {}
        return path
