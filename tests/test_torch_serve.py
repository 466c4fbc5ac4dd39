"""The port's serving daemon (cli/serve.py, serve/) and predict entry point,
against the JAX package's, on the CPU.

film_attn_pt at a small width (1 block x 16 channels, embed/hidden/attention
8, 512 input channels, f32, frame buckets) over a feature cache of the test
split (4 videos of 16 frames, v_len 4, their planes written by a cheap
stand-in stem; see
tests/test_torch_feature_cache.py), each package's file under its own stem
fingerprint, both from one checkpoint:

- ``/predict`` by example id, one request at a time in a fixed order, against
  JAX's ``serve.InferenceEngine.run_batch`` on the same items (the same seed
  gives the same frame picks): f32 probabilities atol 1e-5; with
  ``--int8_trunk true`` (the first batch calibrates on both sides) atol 2e-3
  and the argmax equal;
- concurrent requests micro-batch, with the answers of sequential ones, at
  pipeline depth 1 and 2; ``/stats`` keys and ``/metrics`` names are JAX's;
  400 / 404 / 500 / 503; bucket-aware dispatch and load shedding with stub
  engines; hot reload (a raced calibration is discarded); a stale
  fingerprint and the unported flags refused at start-up; warm-up;
- ``cli/predict.py`` prints JAX's answer for one 8-frame video (both
  packages' ``load_stem`` replaced by the stand-in stem).
"""

import dataclasses
import json
import os
import re
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from videonavqa_tpu.cli import predict as jpredict
from videonavqa_tpu.cli import serve as jserve
from videonavqa_tpu.models import get_model as jax_get_model
from videonavqa_tpu_torch.cli import common as tcommon
from videonavqa_tpu_torch.cli import extract_features as ef
from videonavqa_tpu_torch.cli import predict, serve
from videonavqa_tpu_torch.data.buckets import optimal_frame_buckets
from videonavqa_tpu_torch.data.synthetic import generate_synthetic_dataset
from videonavqa_tpu_torch.datagen import encode, ontology
from videonavqa_tpu_torch.datagen.ontology import ANSWER_VOCAB
from videonavqa_tpu_torch.serve import loadgen
from videonavqa_tpu_torch.serve.batcher import MicroBatcher, Overloaded
from videonavqa_tpu_torch.utils import checkpoint as tckpt

from test_torch_feature_cache import (
    jax_copy, jax_stand_in, jax_weights, torch_stand_in, write_features)

PROB_ATOL = 1e-5
INT8_ATOL = 2e-3
MODEL = ["--model", "film_attn_pt", "--num_res_blocks", "1", "--num_res_block_channels", "16",
         "--embed_size", "8", "--hidden_size", "8", "--at_hidden_size", "8",
         "--num_input_channels", "512", "--vocab_size", "19", "--compute_dtype", "float32"]
QUESTIONS = ["w3 w5 w7", "w1 w2 w3 w4 w5 w6 w7 w8 w9 w10", "w17?", "w4 w4 w2"]


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """(port data dir, JAX data dir, checkpoint, JAX (params, state), test ids)."""
    base = tmp_path_factory.mktemp("serve")
    port_dir = str(base / "port")
    generate_synthetic_dataset(port_dir, num_houses=3, trajs_per_house=4, seed=21,
                               video_format="npy", min_frames=16, max_frames=16)
    with open(os.path.join(port_dir, "vocab.json"), "w") as f:
        json.dump({**{f"w{i}": i for i in range(1, 18)}, "?": 18}, f)
    write_features(port_dir, ["test"])
    ckpt = str(base / "w.npz")
    cfg = tcommon.cfg_from_args(tcommon.build_q_and_v_parser().parse_args(MODEL), "film_attn_pt")
    jtrees = jax_weights(ckpt, cfg, seed=3)
    jdir = jax_copy(port_dir, str(base / "jax"),
                    _jax_parser().parse_args(MODEL + ["--data_dir", port_dir]))
    with open(os.path.join(port_dir, "split.json")) as f:
        ids = sorted(json.load(f)["test"])
    return port_dir, jdir, ckpt, jtrees, ids


def _port_args(data, *extra, port=0):
    port_dir, _, ckpt, _, _ = data
    return serve.build_parser().parse_args(
        MODEL + ["--device", "cpu", "--data_dir", port_dir, "--checkpoint_path", ckpt,
                 "--feature_cache", "true", "--max_batch", "4", "--port", str(port),
                 "--batch_wait_ms", "20", "--bucket_frames", "true", *extra])


def _jax_parser():
    parser = jserve.build_q_and_v_parser()
    parser.add_argument("--max_batch", type=int, default=4)
    parser.add_argument("--batch_wait_ms", type=float, default=20.0)
    parser.add_argument("--serve_split", type=str, default="test")
    return parser


def _jax_engine(data, monkeypatch, *extra):
    """JAX's engine over the JAX copy; its spec's init gives the checkpoint's
    trees (its own eager init takes seconds; every leaf is read over)."""
    _, jdir, ckpt, (jp, js), _ = data
    spec = jax_get_model("film_attn_pt")
    monkeypatch.setattr(jserve, "get_model",
                        lambda name: dataclasses.replace(spec, init=lambda key, cfg: (jp, js)))
    return jserve.InferenceEngine(_jax_parser().parse_args(
        MODEL + ["--data_dir", jdir, "--checkpoint_path", ckpt, "--feature_cache", "true",
                 "--bucket_frames", "true", *extra]))


@pytest.fixture(scope="module")
def jax_f32(data):
    """JAX's f32 engine (one compile for the module); reset its frame picks
    with ``jeng.rng = np.random.RandomState(0)``."""
    with pytest.MonkeyPatch.context() as mp:
        yield _jax_engine(data, mp)


def _serve(server):
    threading.Thread(target=server.serve_forever, kwargs={"poll_interval": 0.05},
                     daemon=True).start()
    return server.server_address[1]


@pytest.fixture
def live(data):
    """A running port daemon (f32, depth 2) -> (engine, batcher, server, port)."""
    engine, batcher, server = serve.build_server(_port_args(data))
    port = _serve(server)
    yield engine, batcher, server, port
    server.shutdown()
    server.server_close()


def _post(port, path, payload=None, raw=None):
    if raw is None:
        return loadgen.request(port, path, payload, timeout=120)
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=raw,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
            return r.status, r.read().decode(), r.headers["Content-Type"]
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), e.headers["Content-Type"]


def _requests(ids):
    return [(ids[i % len(ids)], QUESTIONS[i % len(QUESTIONS)]) for i in (0, 1, 2, 0, 3, 1)]


def _assert_answers_match(responses, jeng, reqs, atol):
    for (status, body), (ex, q) in zip(responses, reqs):
        assert status == 200, body
        frames, vl = jeng.load_example(ex)
        want = jeng.run_batch([(frames, vl, jeng.encode_question(q))])[0]
        got = {ANSWER_VOCAB[a]: p for a, p in body["top"]}
        assert len(got) == 5 and ANSWER_VOCAB[body["answer"]] == int(np.argmax(want))
        for c, p in got.items():
            assert abs(p - float(want[c])) <= atol, (ex, q, c, p, float(want[c]))


def test_predict_by_example_matches_jax_run_batch(data, live, jax_f32):
    engine, _, _, port = live
    jeng = jax_f32
    jeng.rng = np.random.RandomState(0)
    reqs = _requests(data[4])
    responses = [_post(port, "/predict", {"example": ex, "question": q}) for ex, q in reqs]
    _assert_answers_match(responses, jeng, reqs, PROB_ATOL)
    assert engine.stem is None and engine.feature_loader is not None


def test_int8_daemon_matches_jax(data, monkeypatch):
    engine, _, server = serve.build_server(_port_args(data, "--int8_trunk", "true"))
    port = _serve(server)
    try:
        jeng = _jax_engine(data, monkeypatch, "--int8_trunk", "true")
        assert engine.needs_int8_calibration and jeng._needs_int8_calibration
        reqs = _requests(data[4])
        responses = [_post(port, "/predict", {"example": ex, "question": q}) for ex, q in reqs]
        _assert_answers_match(responses, jeng, reqs, INT8_ATOL)
        assert not engine.needs_int8_calibration and not jeng._needs_int8_calibration
        assert set(engine.state["trunk"]["int8_scales"]) == {"conv_init", "conv1x1_0",
                                                             "conv3x3_0"}
    finally:
        server.shutdown()
        server.server_close()


def test_concurrent_requests_micro_batch(data, live):
    """8 concurrent clients (serve/loadgen.py) share forwards."""
    engine, _, _, port = live
    ids = data[4]
    jobs = [{"example": ids[i % 4], "question": QUESTIONS[0]} for i in range(8)]
    _, results = loadgen.run(port, jobs, 8, 8)
    assert sorted(i for i, _, _ in results) == list(range(8))
    assert all(s == 200 and b["answer"] in ANSWER_VOCAB for _, s, b in results)
    s = json.loads(_get(port, "/stats")[1])
    assert s["requests"] == 8 and s["batches"] < 8 and s["errors"] == 0

    # the batcher at depth 1 and 2 gives each request the answer it gets alone
    items = [engine.load_example(ex) + (engine.encode_question(q),)
             for ex, q in _requests(ids)]
    expect = [engine.run_batch([it])[0] for it in items]
    for depth in (1, 2):
        batcher = MicroBatcher(engine, batch_wait_ms=30.0, pipeline_depth=depth)
        got = [None] * 12

        def submit(i):
            got[i] = batcher.submit(*items[i % len(items)])

        threads = [threading.Thread(target=submit, args=(i,)) for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i, g in enumerate(got):
            np.testing.assert_allclose(g, expect[i % len(items)], atol=PROB_ATOL,
                                       err_msg=f"depth {depth}, request {i}")
        assert batcher.stats["requests"] == 12 and batcher.stats["errors"] == 0
        assert batcher.stats["batches"] < 12 and batcher.pending() == 0


def test_stats_and_metrics_are_jax_s(data, live, jax_f32):
    from http.server import ThreadingHTTPServer

    _, _, _, port = live
    ex = data[4][0]
    assert _post(port, "/predict", {"example": ex, "question": QUESTIONS[0]})[0] == 200
    jb = jserve.MicroBatcher(jax_f32, batch_wait_ms=1.0)
    frames, vl = jax_f32.load_example(ex)
    jb.submit(frames, vl, [1, 2])
    jsrv = ThreadingHTTPServer(("127.0.0.1", 0), jserve.make_handler(jax_f32, jb))
    try:
        jport = _serve(jsrv)
        got, want = (json.loads(_get(p, "/stats")[1]) for p in (port, jport))
        assert sorted(got) == sorted(want)
        assert got["stem_fingerprint"] != want["stem_fingerprint"]
        names = lambda text: sorted(re.sub(r"[ {].*", "", line) for line in text.splitlines())
        (code, text, ctype), (_, jtext, jctype) = (_get(p, "/metrics") for p in (port, jport))
        assert code == 200 and ctype == jctype and names(text) == names(jtext)
        got_h, want_h = (json.loads(_get(p, "/healthz")[1]) for p in (port, jport))
        assert sorted(got_h) == sorted(want_h) and got_h["ok"] is True
    finally:
        jsrv.shutdown()
        jsrv.server_close()


def test_error_responses(data, live, monkeypatch):
    engine, batcher, _, port = live
    ex, q = data[4][0], QUESTIONS[0]
    for payload, word in (({"example": ex, "question": "zxqv"}, "vocabulary"),
                          ({"example": "no_such_example", "question": q}, "unknown example"),
                          ({"video": ex, "question": q}, "example"),
                          ({"example": ex}, "question")):
        status, body = _post(port, "/predict", payload)
        assert status == 400 and word in body["error"], body
    status, body = _post(port, "/predict", raw=b"[1, 2]")
    assert status == 400 and "JSON object" in body["error"]
    assert _get(port, "/nope")[0] == 404
    assert _post(port, "/nope", {})[0] == 404
    monkeypatch.setattr(batcher, "max_pending", 0)
    status, body = _post(port, "/predict", {"example": ex, "question": q})
    assert status == 503 and "overloaded" in body["error"]
    monkeypatch.setattr(batcher, "max_pending", 512)

    def broken(items):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(engine, "dispatch_batch", broken)
    status, body = _post(port, "/predict", {"example": ex, "question": q})
    assert status == 500 and "kernel launch failed" in body["error"]
    assert json.loads(_get(port, "/stats")[1])["errors"] == 1


def test_hot_reload(data, live, tmp_path):
    engine, _, _, port = live
    ex, q = data[4][0], QUESTIONS[1]

    def answer():   # the same frame picks each time
        engine.rng = np.random.RandomState(0)
        return _post(port, "/predict", {"example": ex, "question": q})[1]

    before = answer()
    cfg = tcommon.cfg_from_args(tcommon.build_q_and_v_parser().parse_args(MODEL), "film_attn_pt")
    params, state = engine.spec.init(torch.Generator().manual_seed(99), cfg, torch.device("cpu"))
    alt = str(tmp_path / "alt.npz")
    tckpt.save_checkpoint(alt, params=params, state=state, meta={"epoch": 7})
    version = json.loads(_get(port, "/stats")[1])["weights_version"]
    assert _post(port, "/reload", {"checkpoint_path": alt}) == (200, {"ok": True, "epoch": 7})
    assert json.loads(_get(port, "/healthz")[1])["epoch"] == 7
    assert json.loads(_get(port, "/stats")[1])["weights_version"] == version + 1
    after = answer()
    assert after["top"] != before["top"]
    bad = str(tmp_path / "corrupt.npz")
    with open(bad, "wb") as f:
        f.write(b"not a checkpoint")
    for path in (str(tmp_path / "absent.npz"), bad):
        assert _post(port, "/reload", {"checkpoint_path": path})[0] == 400
    assert json.loads(_get(port, "/stats")[1])["weights_version"] == version + 1
    assert answer()["top"] == after["top"]
    assert _post(port, "/reload", {}) == (200, {"ok": True, "epoch": 0})   # the startup file


def test_reload_rearms_and_a_raced_calibration_is_discarded(data):
    eng = serve.InferenceEngine.from_args(_port_args(data, "--int8_trunk", "true"))
    item = eng.load_example(data[4][0]) + ([2, 3],)
    eng.run_batch([item])
    assert not eng.needs_int8_calibration and "int8_scales" in eng.state["trunk"]
    eng.reload()
    assert eng.needs_int8_calibration and "int8_scales" not in eng.state["trunk"]
    real = eng._forward_calibrate

    def racing(*a, **k):
        out = real(*a, **k)
        eng.reload()   # lands between the calibration forward and its commit
        return out

    eng._forward_calibrate = racing
    version = eng.weights_version
    eng.run_batch([item])
    assert eng.weights_version == version + 1
    assert eng.needs_int8_calibration and "int8_scales" not in eng.state["trunk"]
    eng._forward_calibrate = real
    eng.run_batch([item])
    assert not eng.needs_int8_calibration and "int8_scales" in eng.state["trunk"]


def test_buckets_and_warmup(data):
    plain = serve.InferenceEngine.from_args(_port_args(data, "--bucket_frames", "false"))
    auto = serve.InferenceEngine.from_args(_port_args(data, "--bucket_frames", "auto",
                                                      "--int8_trunk", "true"))
    assert plain.frame_buckets == () and plain.bucket_for(4) == 35
    assert auto.frame_buckets == optimal_frame_buckets(auto.feature_loader.lengths) == (4,)
    items = [plain.load_example(ex) + ([1, 2, 3],) for ex in data[4][:2]]
    auto_f32 = serve.InferenceEngine.from_args(_port_args(data, "--bucket_frames", "auto"))
    np.testing.assert_allclose(auto_f32.run_batch(items), plain.run_batch(items), atol=PROB_ATOL)
    assert serve.InferenceEngine.from_args(_port_args(data)).frame_buckets == (
        8, 12, 16, 20, 24, 28, 32, 35)
    seen = []
    real = auto.dispatch_batch
    auto.dispatch_batch = lambda its: seen.append(its[0][0].shape) or real(its)
    auto.warmup()   # calibrates on a stored example, then one batch per bucket
    assert not auto.needs_int8_calibration and len(seen) == 2


def test_video_mode_warmup_recalibrates_on_real_traffic(data, monkeypatch):
    monkeypatch.setattr(tcommon, "load_stem", lambda *a, **k: torch_stand_in)
    args = _port_args(data, "--int8_trunk", "true", "--bucket_frames", "true", "--max_batch", "1")
    args.feature_cache = False
    eng = serve.InferenceEngine.from_args(args)
    assert callable(eng.stem) and eng.frame_shape == (160, 208, 3)
    eng.warmup()
    assert eng.needs_int8_calibration   # re-armed: real traffic sets the scales
    provisional = {k: float(v) for k, v in eng.state["trunk"]["int8_scales"].items()}
    assert all(v > 0 for v in provisional.values())
    frames, vl = eng.load_video(data[4][0])
    assert frames.dtype == np.uint8 and vl == 4
    eng.run_batch([(frames, vl, [2, 3])])
    assert not eng.needs_int8_calibration
    committed = eng.state["trunk"]["int8_scales"]
    assert any(float(committed[k]) != provisional[k] for k in provisional)
    with pytest.raises(FileNotFoundError):
        eng.load_video("no_such_video")
    with pytest.raises(ValueError, match="decodes videos"):
        eng.load_example(data[4][0])


def test_microbatcher_bucket_aware_dispatch():
    """A saturated backlog dispatches the oldest request's bucket pure where it
    fills a batch; an underfull mix goes as one batch; every request is
    answered and each carried one counts once in ``deferred``."""

    class StubEngine:
        B = 4
        frame_buckets = (8, 12, 16, 20, 24, 28, 32, 35)

        def __init__(self):
            self.batches = []

        def bucket_for(self, v_len):
            return min((t for t in self.frame_buckets if t >= max(v_len, 1)), default=35)

        def run_batch(self, items):
            time.sleep(0.2)   # the queue builds up behind this forward
            self.batches.append([vl for _, vl, _ in items])
            return np.zeros((len(items), 70))

    engine = StubEngine()
    mb = MicroBatcher(engine, batch_wait_ms=30.0)
    lens = [2, 3, 4, 5, 2, 3, 4, 5, 6, 15, 16]
    threads = [threading.Thread(target=lambda vl=vl: mb.submit(np.zeros((1, 1)), vl, [1]))
               for vl in lens]
    for t in threads:
        t.start()
        time.sleep(0.002)   # arrival order
    for t in threads:
        t.join()
    assert sorted(sum(engine.batches, [])) == sorted(lens)
    assert all(len(b) <= 4 for b in engine.batches)
    first = engine.batches[0]
    assert len(first) == 4 and all(vl <= 8 for vl in first)   # pure and full
    assert mb.stats["requests"] == 11 and mb.stats["errors"] == 0
    assert 1 <= mb.stats["deferred"] <= len(lens)

    engine2 = StubEngine()
    mb2 = MicroBatcher(engine2, batch_wait_ms=60.0)
    threads = [threading.Thread(target=lambda vl=vl: mb2.submit(np.zeros((1, 1)), vl, [1]))
               for vl in (2, 15)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert engine2.batches and sorted(engine2.batches[0]) == [2, 15]


def test_microbatcher_sheds_load_past_max_pending():
    release = threading.Event()

    class SlowEngine:
        B = 2
        frame_buckets = ()

        def bucket_for(self, v_len):
            return 35

        def run_batch(self, items):
            release.wait(5.0)
            return np.zeros((len(items), 70))

    mb = MicroBatcher(SlowEngine(), batch_wait_ms=1.0, max_pending=2)
    results = []
    threads = [threading.Thread(target=lambda: results.append(mb.submit(np.zeros(1), 1, [1])))
               for _ in range(2)]
    for t in threads:
        t.start()
    time.sleep(0.3)
    with pytest.raises(Overloaded):
        mb.submit(np.zeros(1), 1, [1])
    assert mb.stats["rejected"] == 1
    release.set()
    for t in threads:
        t.join()
    assert len(results) == 2 and mb.pending() == 0


@pytest.mark.parametrize("depth", [1, 2])
def test_microbatcher_under_thread_stress(depth):
    """More submitting threads than cores and a short switch interval: each
    request gets its own row back, and the counters add up."""
    import sys

    class EchoEngine:
        B = 4
        frame_buckets = ()

        def bucket_for(self, v_len):
            return 35

        def dispatch_batch(self, items):
            return np.array([[float(vl)] for _, vl, _ in items]), len(items), None

        @staticmethod
        def fetch(handle):
            return handle[0]

        def run_batch(self, items):
            return self.fetch(self.dispatch_batch(items))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        mb = MicroBatcher(EchoEngine(), batch_wait_ms=0.5, pipeline_depth=depth)
        wrong = []

        def client(c):
            for j in range(10):
                key = 100 * c + j
                if float(mb.submit(None, key, [1])[0]) != key:
                    wrong.append(key)

        threads = [threading.Thread(target=client, args=(c,)) for c in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not wrong
    assert mb.stats["requests"] == 320 and mb.stats["errors"] == 0 and mb.pending() == 0
    assert len(mb._latencies) == 320


def test_stale_or_missing_cache_is_refused(data):
    with pytest.raises(SystemExit, match="different stem"):
        serve.build_server(_port_args(data, "--compute_dtype", "bfloat16"))
    with pytest.raises(SystemExit, match="run videonavqa_tpu_torch.cli.extract_features"):
        serve.build_server(_port_args(data, "--serve_split", "val"))
    with pytest.raises(SystemExit, match="frozen-stem model"):
        serve.InferenceEngine.from_args(_port_args(data, "--model", "v_only_cnn2d_lstm"))


@pytest.mark.parametrize("extra, item", [
    (["--mesh_devices", "2"], "multi-GPU"),
    (["--model_parallel", "2"], "multi-GPU"),
    (["--model", "v_only_cnn3d", "--mesh_devices", "2"], "multi-GPU"),
    (["--q_encoder", "bow", "--model_parallel", "2"], "multi-GPU"),
], ids=lambda v: "A8" if v == "multi-GPU" else None)   # the ids the cases had as item A8
def test_unported_flags_exit_naming_their_item(data, extra, item):
    with pytest.raises(SystemExit, match=item):
        serve.build_server(_port_args(data, *extra))


def test_without_a_card_the_entry_points_raise(data, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _port_args(data)
    args.device = "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.InferenceEngine.from_args(args)
    port_dir, _, ckpt, _, ids = data
    with pytest.raises(RuntimeError, match="CUDA"):
        ef.main(["--data_dir", port_dir])
    with pytest.raises(RuntimeError, match="CUDA"):
        predict.main(MODEL + ["--data_dir", port_dir, "--checkpoint_path", ckpt, "--video",
                              os.path.join(port_dir, "videos", ids[0]), "--question", "w1"])


def test_predict_prints_jax_s_answer(data, tmp_path, monkeypatch, capsys):
    port_dir, _, ckpt, (jp, js), _ = data
    video = np.load(os.path.join(port_dir, "videos", sorted(os.listdir(
        os.path.join(port_dir, "videos")))[0]))[:8]
    np.save(tmp_path / "clip.npy", video)
    spec = jax_get_model("film_attn_pt")
    monkeypatch.setattr(jpredict, "get_model",
                        lambda name: dataclasses.replace(spec, init=lambda key, cfg: (jp, js)))
    monkeypatch.setattr(jpredict, "load_stem", lambda *a, **k: jax_stand_in)
    monkeypatch.setattr(predict, "load_stem", lambda *a, **k: torch_stand_in)
    argv = MODEL + ["--data_dir", port_dir, "--checkpoint_path", ckpt, "--video",
                    str(tmp_path / "clip.npy"), "--question", "W3 w5, w7?", "--seed", "4"]
    jpredict.main(argv)
    want = capsys.readouterr().out.splitlines()
    probs = predict.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 6 and got[0] == want[0] and got[0].startswith("Answer: ")
    for g, w in zip(got[1:], want[1:]):
        assert g.split()[0] == w.split()[0]
        assert abs(float(g.split()[-1]) - float(w.split()[-1])) <= 1e-4
    assert probs.shape == (70,) and abs(float(probs.sum()) - 1.0) < 1e-5


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_subsample_frames_keeps_the_dtype_as_jax(dtype):
    """u8 pixels, and the bits of bf16 (uint16) and fp8 (uint8) planes."""
    from videonavqa_tpu.data.pipeline import subsample_frames as jsubsample

    from videonavqa_tpu_torch.data.pipeline import subsample_frames

    raw = np.random.default_rng(5).integers(0, np.iinfo(dtype).max, (37, 10, 13, 4), dtype=dtype)
    got = subsample_frames(raw, np.random.RandomState(8), dtype=raw.dtype)
    want = jsubsample(raw, np.random.RandomState(8), dtype=raw.dtype)
    assert got[1] == want[1] == 10 and got[0].dtype == want[0].dtype == dtype
    np.testing.assert_array_equal(got[0], want[0])


def test_tokenize_and_answer_vocab_are_jax_s():
    from videonavqa_tpu.datagen import encode as jencode
    from videonavqa_tpu.datagen import ontology as jontology

    for text in ("Is there a blue table in the kitchen?", "What's on the /left/? 3 chairs",
                 "  MIXED case_words and   spaces "):
        assert encode.tokenize(text) == jencode.tokenize(text)
    assert ontology.ANSWER_VOCAB == jontology.ANSWER_VOCAB
    assert ontology.QUERY_OBJECTS == jontology.QUERY_OBJECTS
