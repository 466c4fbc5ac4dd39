"""labels.json / q_ids.json writer (scripts/write_labels.py:87-109) over the
canonical 70-class answer map."""

from __future__ import annotations

import json
import os

from videonavqa_tpu_torch.datagen.ontology import ANSWER_VOCAB


def write_labels(data_dir, labels_file, q_ids_file):
    labels, q_ids = {}, {}
    for filename in sorted(os.listdir(data_dir)):
        if not filename.endswith(".json"):
            continue
        with open(os.path.join(data_dir, filename)) as f:
            data = json.load(f)
        house_id = filename.split(".")[0]
        for traj_id, entry in data.items():
            example_id = "%s_%04d" % (house_id, int(traj_id))
            label = entry["q_ans"]
            assert str(label) in ANSWER_VOCAB, f"Label {label} not found!"
            labels[example_id] = ANSWER_VOCAB[str(label)]
            q_ids[example_id] = entry["q_id"]
    with open(labels_file, "w") as f:
        json.dump(labels, f)
    with open(q_ids_file, "w") as f:
        json.dump(q_ids, f)
    return labels, q_ids
