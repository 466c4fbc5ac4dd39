"""Per-template question/answer distribution statistics
(scripts/stats_for_generated_questions.py:68-123)."""

from __future__ import annotations

import json
import os

from videonavqa_tpu_torch.datagen.templates import SORTED_TEMPLATE_KEYS


def dataset_stats(data_dir):
    """Aggregate {template_id: {q_text: {answer: count}}} plus summary counts."""
    per_template = {}
    for filename in sorted(os.listdir(data_dir)):
        if not filename.endswith(".json"):
            continue
        with open(os.path.join(data_dir, filename)) as f:
            data = json.load(f)
        for entry in data.values():
            bucket = per_template.setdefault(entry["q_id"], {})
            answers = bucket.setdefault(entry["q_text"], {})
            key = str(entry["q_ans"])
            answers[key] = answers.get(key, 0) + 1

    total = unique = 0
    all_classes = set()
    count_per_template, ans_per_template = {}, {}
    for q_id, questions in per_template.items():
        name = f"{q_id}-{SORTED_TEMPLATE_KEYS[q_id]}"
        unique += len(questions)
        count_per_template[name] = 0
        ans_per_template[name] = {}
        for answers in questions.values():
            for ans, n in answers.items():
                all_classes.add(ans)
                total += n
                count_per_template[name] += n
                ans_per_template[name][ans] = ans_per_template[name].get(ans, 0) + n

    return {
        "total_questions": total,
        "unique_questions": unique,
        "num_classes": len(all_classes),
        "classes": {c: i for i, c in enumerate(sorted(all_classes))},
        "count_per_template": count_per_template,
        "answers_per_template": ans_per_template,
    }
