"""The batch-serving daemon: an HTTP endpoint over the eval forward (the port
of the JAX package's cli/serve.py).

Requests are micro-batched (``serve/batcher.py``): up to ``--max_batch``
requests, or what arrived within ``--batch_wait_ms`` of the first, run as one
padded forward; at ``--pipeline_depth`` >= 2 the next batch's staging and
copy to the card overlap the current batch's forward. With
``--bucket_frames`` each batch's frame axis is trimmed to the smallest frame
bucket covering its longest video (``auto``: the buckets that cost least for
the feature cache's own lengths). ``--int8_trunk true`` calibrates static
int8 activation scales on the first micro-batch (at warm-up, on a stored
example, over a feature cache). ``--feature_cache true`` serves precomputed
frozen-stem features (``cli/extract_features.py``) by example id, refusing a
cache whose stem fingerprint is stale; without it a stem model is served from
stored videos through the stem, and a model that takes raw frames
(v_only_cnn2d_lstm, v_only_cnn3d, concat2d, concat3d) from stored videos
itself: the C3D models' trimmed buckets through the zero-run splice, from a
zero-run computed with each weights version. On the card the kernels run
(the FiLM models: the re-encode, the fused int8 1x1 conv and film_attn_pt's
attention tail; the LSTM models' masked LSTM; the stem's block 1), built at
warm-up; a kernel that fails to build fails the start-up.

    python -m videonavqa_tpu_torch.cli.serve --model film_attn_pt \\
        --data_dir /path/to/data --checkpoint_path e0_film.npz \\
        --num_res_blocks 5 --num_res_block_channels 1024 --feature_cache true \\
        --int8_trunk true --bucket_frames auto --max_batch 32 --port 8808

The paths and bodies are ``serve/http.py``'s. SIGTERM or SIGINT stops
accepting connections, answers every accepted request and exits.
``--int8_stem true`` serves a stem model from video through the int8 stem,
calibrated at start-up on one stored video (``--int8_stem_calibration_video``,
else the alphabetically first under ``videos/``). ``--mesh_devices N
[--model_parallel M]`` serves on N devices of this process: a replica on
each 'data' device, the micro-batch's rows split over them (``--max_batch``
must divide by the 'data' axis), the widest projections' rows split over a
data row's 'model' devices (``serve/engine.py``); ``--distributed`` exits,
as serving is single-process.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from http.server import ThreadingHTTPServer

from videonavqa_tpu_torch.cli.common import _true
from videonavqa_tpu_torch.cli.common import build_q_and_v_parser as _build_base_parser
from videonavqa_tpu_torch.serve.batcher import MicroBatcher
from videonavqa_tpu_torch.serve.engine import InferenceEngine
from videonavqa_tpu_torch.serve.http import make_handler


def build_q_and_v_parser():
    """The training harness's flags, with --model widened to the video-only
    zoo members the daemon also serves, as the JAX daemon's."""
    parser = _build_base_parser()
    for action in parser._actions:
        if action.dest == "model":
            action.choices = sorted(set(action.choices) | {"v_only_cnn3d", "v_only_cnn2d_lstm"})
    return parser


def build_parser():
    """build_q_and_v_parser with the daemon's own flags."""
    parser = build_q_and_v_parser()
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8808)
    parser.add_argument("--max_batch", type=int, default=8, help="micro-batch cap")
    parser.add_argument("--batch_wait_ms", type=float, default=5.0,
                        help="wait this long after the first request for more before "
                             "dispatching the batch")
    parser.add_argument("--serve_split", type=str, default="test",
                        help="with --feature_cache: the split whose feature file to serve")
    parser.add_argument("--example_cache", type=int, default=64,
                        help="with --feature_cache: LRU size (in examples) of decoded feature "
                             "planes (~19 MB each bf16); 0 disables")
    parser.add_argument("--max_pending", type=int, default=512,
                        help="shed load with 503 past this many outstanding requests")
    parser.add_argument("--pipeline_depth", type=int, default=2,
                        help="micro-batches in flight on the card: at >= 2 the next batch's "
                             "staging and copy overlap the current forward (1 = synchronous)")
    parser.add_argument("--int8_stem_calibration_video", type=str, default=None,
                        help="with --int8_stem (video mode): the stored video to calibrate "
                             "the stem's activation scales on at start-up (default: the "
                             "first video in videos/)")
    parser.add_argument("--warmup", type=_true, default=True,
                        help="build the kernels and run every serving shape (and the int8 "
                             "calibration) before accepting traffic")
    return parser


class Server(ThreadingHTTPServer):
    # the stdlib's backlog of 5 refuses a burst of reconnecting clients
    request_queue_size = 128
    daemon_threads = True


def build_server(args):
    """(engine, batcher, server): the server is bound but not serving."""
    engine = InferenceEngine.from_args(args)
    batcher = MicroBatcher(engine, batch_wait_ms=args.batch_wait_ms,
                           max_pending=getattr(args, "max_pending", 512),
                           pipeline_depth=getattr(args, "pipeline_depth", 2))
    server = Server((args.host, args.port), make_handler(engine, batcher))
    return engine, batcher, server


def drain(server, batcher, timeout=30.0):
    """After ``server.shutdown()``: wait until every accepted request is
    answered (or ``timeout`` s), let the last responses flush, close the
    socket and end the batcher's threads. -> the requests still pending (0
    when drained)."""
    deadline = time.monotonic() + timeout
    while batcher.pending() and time.monotonic() < deadline:
        time.sleep(0.05)
    time.sleep(0.5)
    server.server_close()
    left = batcher.pending()
    if not left:
        batcher.close()
    return left


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.model:
        raise SystemExit("--model is required")
    if not args.checkpoint_path or not os.path.exists(args.checkpoint_path):
        raise SystemExit("--checkpoint_path is required for serving")

    engine, batcher, server = build_server(args)
    if args.warmup:
        print("warming up: building the kernels and running every serving shape...")
        engine.warmup()

    def _drain(signum, frame):
        print(f"signal {signum}: draining {batcher.pending()} pending requests...")
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _drain)
    signal.signal(signal.SIGINT, _drain)
    print(f"serving {args.model} on http://{args.host}:{server.server_address[1]} "
          f"(max_batch {args.max_batch}, kernels={engine.cfg.use_pallas_kernels}, "
          f"int8_trunk={engine.cfg.use_int8_trunk}, int8_stem={engine.stem_is_int8}, "
          f"device={engine.device}, "
          f"buckets={engine.frame_buckets or 'off'})")
    server.serve_forever()
    drain(server, batcher)
    print("drained; bye")


if __name__ == "__main__":
    main()
