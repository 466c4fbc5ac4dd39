"""End-to-end dataset generation over the synthetic renderer backend (the
port of the JAX package's cli/generate_dataset.py; all numpy, no torch).

Replaces the reference's per-house drivers
(scripts/generate_questions_for_trajectories.py,
scripts/generate_trajectories.py, scripts/generate_videos_for_trajectories.py)
for the hermetic backend: per house it builds a scene graph, samples random
room-to-room trajectories with look-arounds, renders videos, observes
seen rooms/objects, generates balanced questions, then writes labels.json,
q_ids.json, split.json and encoded_questions/ — a complete dataset the
training harnesses consume directly.

SUNCG/House3D generation remains an external backend: plug a renderer with
the same three-mode interface plus ground-truth rooms into the same pipeline.

``--video_format mp4`` (the default) writes every file byte-equal to the JAX
package's generator from the same seed; it needs OpenCV. ``--video_format
npy`` writes each video as ``videos/<id>.npy``, the uint8 [T, 160, 208, 3]
frames the mp4 encoder would be given, for machines without OpenCV (the
port's loaders prefer ``.npy``); every other file is the same as the mp4
run's. ``--workers N`` generates houses in a pool of spawned processes: the
caller may hold a CUDA context, which a forked child must not inherit.

    python -m videonavqa_tpu_torch.cli.generate_dataset --out /tmp/gen \\
        --num_houses 10 --trajs_per_house 8 --workers 4 --video_format npy
"""

from __future__ import annotations

import argparse
import os
import random
import zlib

import numpy as np

from videonavqa_tpu_torch.data.synthetic import _write_mp4
from videonavqa_tpu_torch.datagen.encode import encode_questions
from videonavqa_tpu_torch.datagen.engine import QuestionEngine
from videonavqa_tpu_torch.datagen.labels import write_labels
from videonavqa_tpu_torch.datagen.renderer import (
    SyntheticRenderer, generate_path, generate_synthetic_house,
)
from videonavqa_tpu_torch.datagen.scene import SceneGraph
from videonavqa_tpu_torch.datagen.split import build_split, split_houses
from videonavqa_tpu_torch.datagen.trajectory import TrajectoryObserver, add_lookarounds


def _house_rngs(seed, house_idx):
    """Independent, platform-stable per-house RNGs (crc32 keying, like the
    loader's subsample RNG, data/pipeline.py:146-149). Per-house seeding makes
    houses order-independent, so N parallel workers produce bit-identical
    artifacts to a sequential run."""
    s = zlib.crc32(f"{seed}/house{house_idx}".encode()) & 0x7FFFFFFF
    return random.Random(s), np.random.RandomState(s ^ 0x5EED)


def generate_house(house_idx, out_dir, *, seed, trajs_per_house,
                   num_rooms, verbose=False, resume=False, video_format="mp4"):
    """Generates one house with its own RNGs and its own QuestionEngine —
    self-contained, exactly like the reference's resumable one-job-per-house
    drivers (scripts/generate_trajectories.py:23-54; question balancing and
    question|answer dedup are therefore per-house there too). All outputs are
    per-house files (atomic writes), so houses can generate concurrently.

    With ``resume``, houses whose question JSON already exists are skipped
    (the reference's skip-if-output-exists pattern,
    scripts/generate_questions_for_trajectories.py:68-72)."""
    questions_dir = os.path.join(out_dir, "questions")
    house_id = f"synth{house_idx:04d}"
    if resume and os.path.exists(os.path.join(questions_dir, house_id + ".json")):
        return house_id, 0
    rng, nprng = _house_rngs(seed, house_idx)
    engine = QuestionEngine(questions_dir, rng)
    house = generate_synthetic_house(nprng, num_rooms=num_rooms)
    renderer = SyntheticRenderer(house)
    videos_dir = os.path.join(out_dir, "videos")
    os.makedirs(videos_dir, exist_ok=True)

    generated = 0
    trajectories = []
    video_lengths = {}
    for traj_id in range(trajs_per_house):
        scene = SceneGraph(house.rooms)  # fresh seen/visited state per trajectory
        a, b = nprng.choice(len(house.rooms), size=2, replace=False)
        coors = generate_path(house, int(a), int(b), nprng)
        coors = add_lookarounds(coors, scene)
        trajectories.append(np.asarray(coors, dtype=np.float32))

        observer = TrajectoryObserver(scene, renderer)
        observer.observe(coors)

        example = engine.generate_for_trajectory(traj_id, scene, verbose=verbose)
        if example is None:
            continue
        frames = observer.render_video(coors)
        base = os.path.join(videos_dir, "%s_%04d" % (house_id, traj_id))
        if video_format == "mp4":
            _write_mp4(base + ".mp4", frames)
        else:
            np.save(base + ".npy", frames)
        video_lengths[traj_id] = int(frames.shape[0])
        generated += 1

    # per-house trajectory archive (the reference's <house>_trajs.npy artifact,
    # scripts/generate_trajectories.py:23-54) and video-length JSON
    # (scripts/generate_videos_for_trajectories.py:51-65)
    traj_dir = os.path.join(out_dir, "trajectories")
    os.makedirs(traj_dir, exist_ok=True)
    np.save(os.path.join(traj_dir, house_id + ".npy"),
            np.array(trajectories, dtype=object), allow_pickle=True)
    import json

    with open(os.path.join(traj_dir, house_id + "_video_lengths.json"), "w") as f:
        json.dump(video_lengths, f)

    engine.dump_dataset(house_id)
    return house_id, generated


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--num_houses", type=int, default=4)
    parser.add_argument("--trajs_per_house", type=int, default=8)
    parser.add_argument("--num_rooms", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--resume", action="store_true",
                        help="skip houses whose question JSON already exists")
    parser.add_argument("--workers", type=int, default=1,
                        help="generate houses in parallel with a process pool "
                             "(per-house RNGs/engines make outputs bit-"
                             "identical to --workers 1; the reference scales "
                             "the same way, one resumable job per house)")
    parser.add_argument("--video_format", type=str, default="mp4", choices=["mp4", "npy"],
                        help="mp4 (needs OpenCV; byte-equal to the JAX package's "
                             "generator) or npy (the uint8 frames the mp4 encoder "
                             "is given, for machines without OpenCV)")
    args = parser.parse_args(argv)

    questions_dir = os.path.join(args.out, "questions")
    kw = dict(seed=args.seed, trajs_per_house=args.trajs_per_house,
              num_rooms=args.num_rooms, verbose=args.verbose,
              resume=args.resume, video_format=args.video_format)
    if args.workers > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(max_workers=args.workers,
                                 mp_context=multiprocessing.get_context("spawn")) as pool:
            futs = [pool.submit(generate_house, h, args.out, **kw)
                    for h in range(args.num_houses)]
            results = [f.result() for f in futs]  # house-index order
    else:
        results = [generate_house(h, args.out, **kw)
                   for h in range(args.num_houses)]

    house_ids = []
    total = 0
    for house_id, generated in results:
        house_ids.append(house_id)
        total += generated
        print(f"{house_id}: {generated} examples")

    write_labels(questions_dir,
                 os.path.join(args.out, "labels.json"),
                 os.path.join(args.out, "q_ids.json"))
    vocab, _ = encode_questions(questions_dir, os.path.join(args.out, "encoded_questions"))
    with open(os.path.join(args.out, "vocab.json"), "w") as f:
        import json

        json.dump(vocab, f)
    build_split(questions_dir, split_houses(house_ids, seed=args.seed),
                os.path.join(args.out, "split.json"))
    print(f"wrote {total} examples ({len(vocab)} vocab tokens) to {args.out}")


if __name__ == "__main__":
    main()
