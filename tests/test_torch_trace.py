"""The port's spans and counters (``utils/logging.py``) on the CPU: off, they
record nothing, read no clock and make no CUDA event; on, the engine, the
batcher, the train step and the feed record their spans under the ids that
tie one micro-batch together, on the clock the benchmark's spans use."""

import threading
import time
import types

import pytest
import torch

from videonavqa_tpu_torch.data.prefetch import device_prefetch
from videonavqa_tpu_torch.models import ModelConfig
from videonavqa_tpu_torch.serve.batcher import MicroBatcher
from videonavqa_tpu_torch.serve.engine import InferenceEngine, _Handle
from videonavqa_tpu_torch.train.step import make_optimizer, make_train_step
from videonavqa_tpu_torch.utils import logging as tlog

SMALL = dict(num_classes=7, vocab_size=19, embed_size=8, hidden_size=8, at_hidden_size=8,
             num_res_blocks=1, num_res_block_channels=8, num_input_channels=4,
             num_tail_channels=4, max_num_frames=6, max_q_len=9, compute_dtype="float32")


@pytest.fixture
def traced():
    """Tracing on for the test, off and drained after it."""
    tlog.trace_on()
    yield
    tlog.trace_off()
    tlog.trace_drain()


def names(record):
    return [s["name"] for s in record["spans"]]


class FakeEngine:
    """dispatch_batch / fetch of a MicroBatcher's engine: each fetch takes
    ``fetch_s``; notes the span batch id each dispatch ran under."""

    frame_buckets = ()

    def __init__(self, B, fetch_s=0.0):
        self.B, self.fetch_s = B, fetch_s
        self.dispatched = []   # (batch id, number of items)

    def dispatch_batch(self, items):
        self.dispatched.append((tlog.current_batch(), len(items)))
        return [it[2] for it in items]

    def fetch(self, handle):
        time.sleep(self.fetch_s)
        return handle

    def run_batch(self, items):
        return self.fetch(self.dispatch_batch(items))


def submit_all(batcher, n):
    out = [None] * n

    def send(k):
        out[k] = batcher.submit(None, 1, k)

    threads = [threading.Thread(target=send, args=(k,)) for k in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads)
    return out


def tiny_step():
    """A train step over a linear model on stem features of a 2-frame video."""
    spec = types.SimpleNamespace(
        uses_stem=True,
        apply=lambda params, state, batch, cfg, train, generator:
            (batch["v_features"].flatten(1) @ params["w"], state))
    params = {"w": torch.zeros(6, 3)}
    step = make_train_step(spec, None, make_optimizer(params, 1e-2), clip_value=1.0,
                           stem_fn=lambda v: v.mean(dim=(2, 3)))
    batch = {"video": torch.randint(0, 255, (4, 2, 5, 7, 3), dtype=torch.uint8),
             "label": torch.tensor([0, 1, 2, 0])}
    return step, params, batch


def test_tracing_off_records_nothing_reads_no_clock_and_makes_no_event(monkeypatch):
    def no_clock():
        raise AssertionError("a clock was read with tracing off")

    def no_event(*args, **kwargs):
        raise AssertionError("a CUDA event was made with tracing off")

    tlog.trace_off()
    tlog.trace_drain()
    monkeypatch.setattr(time, "time_ns", no_clock)
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    assert not tlog.tracing()
    first = tlog.span("x", batch=1, device=True)
    assert first is tlog.span("y")            # one shared no-op context
    with first, tlog.span("stem", device=True):
        assert tlog.current_batch() is None
    tlog.wait_span("batcher.queue", 0, request=1, batch=1)
    batcher = MicroBatcher(FakeEngine(B=2), batch_wait_ms=1.0, pipeline_depth=2)
    assert submit_all(batcher, 3) == [0, 1, 2]
    batcher.close()
    step, params, batch = tiny_step()
    step(params, {}, batch)
    list(device_prefetch(range(2), lambda k: ({"x": torch.ones(2)}, k), "cpu"))
    monkeypatch.undo()
    assert tlog.trace_drain() == {"spans": [], "counters": {"conv3x3_int8.launches": 0}}


def test_nesting_parents_threads_and_drain(traced):
    with tlog.span("outer", batch=7) as outer:
        assert tlog.current_batch() == 7
        with tlog.span("inner", request=3) as inner:
            time.sleep(0.002)
        with tlog.span("stem", device=True):   # no card: host times only
            pass

    def other():
        with tlog.span("elsewhere"):
            tlog.wait_span("handed.over", queued, batch=9)

    queued = time.time_ns()
    t = threading.Thread(target=other, name="other-thread")
    t.start()
    t.join(10)
    assert not t.is_alive()
    record = tlog.trace_drain()
    by_name = {s["name"]: s for s in record["spans"]}
    assert set(by_name) == {"outer", "inner", "stem", "elsewhere", "handed.over"}
    assert by_name["inner"]["parent"] == outer.id and by_name["outer"]["parent"] is None
    assert by_name["inner"]["batch"] == 7 and by_name["inner"]["request"] == 3   # inherited
    assert by_name["inner"]["id"] == inner.id
    o, i = by_name["outer"], by_name["inner"]
    assert o["start_ns"] <= i["start_ns"] < i["end_ns"] <= o["end_ns"]
    assert i["end_ns"] - i["start_ns"] >= 2e6
    assert "device_ms" not in by_name["stem"] and by_name["stem"]["parent"] == outer.id
    assert by_name["outer"]["thread"] == threading.current_thread().name
    assert by_name["elsewhere"]["thread"] == "other-thread"
    wait = by_name["handed.over"]
    assert wait["wait"] and wait["batch"] == 9 and wait["start_ns"] == queued
    assert wait["thread"] == "other-thread" and wait["parent"] is None
    assert "wait" not in by_name["elsewhere"]
    assert [s["start_ns"] for s in record["spans"]] == sorted(
        s["start_ns"] for s in record["spans"])
    assert tlog.trace_drain()["spans"] == []    # the drain cleared the record
    with tlog.span("after"):
        pass
    assert names(tlog.trace_drain()) == ["after"]


def test_engine_spans_share_one_batch_id(traced):
    eng = InferenceEngine(ModelConfig(**SMALL), max_batch=2, device="cpu", frame_buckets=())
    feats = torch.rand(6, 10, 13, 4).numpy()
    eng.run_batch([(feats, 3, [1, 2])])
    tlog.trace_drain()
    handle = eng.dispatch_batch([(feats, 3, [1, 2]), (feats, 5, [4])])
    assert len(handle) == 3
    probs, n, ready = handle                      # what callers unpack
    assert n == 2 and ready is None and probs.shape == (2, 7)
    eng.fetch(handle)
    spans = tlog.trace_drain()["spans"]
    assert names({"spans": spans}) == ["engine.make_batch", "engine.forward"]
    assert {s["batch"] for s in spans} == {handle.batch} and handle.batch == 1
    # on the CPU the probabilities are on the host at once; on the card
    # ``fetch`` waits on the ready event under the handle's batch id
    ready = types.SimpleNamespace(synchronize=lambda: None)
    on_card = _Handle(types.SimpleNamespace(numpy=lambda: probs), n, ready, handle.batch)
    assert eng.fetch(on_card) is probs
    (fetch,) = tlog.trace_drain()["spans"]
    assert (fetch["name"], fetch["batch"]) == ("engine.fetch", handle.batch)


def test_engine_stem_span_in_video_mode(traced):
    eng = InferenceEngine(ModelConfig(**{**SMALL, "model": "film_attn_pt"}), max_batch=1,
                          device="cpu", frame_buckets=(), from_video=True,
                          stem=lambda video: torch.zeros(*video.shape[:2], 10, 13, 4))
    eng.run_batch([(torch.zeros(2, 160, 208, 3, dtype=torch.uint8).numpy(), 2, [1])])
    spans = tlog.trace_drain()["spans"]
    by_name = {s["name"]: s for s in spans}
    assert by_name["stem"]["parent"] == by_name["engine.forward"]["id"]
    assert by_name["stem"]["batch"] == by_name["engine.forward"]["batch"]


def test_batcher_queue_and_inflight_spans(traced):
    eng = FakeEngine(B=1, fetch_s=0.05)
    batcher = MicroBatcher(eng, batch_wait_ms=0.0, pipeline_depth=2)
    assert sorted(submit_all(batcher, 5)) == [0, 1, 2, 3, 4]
    batcher.close()
    spans = tlog.trace_drain()["spans"]
    queue = [s for s in spans if s["name"] == "batcher.queue"]
    assert len(queue) == 5 and all(s["wait"] for s in queue)
    assert sorted(s["request"] for s in queue) == [0, 1, 2, 3, 4]
    # each request's wait carries its micro-batch's number, the one the
    # engine's call ran under
    assert sorted(s["batch"] for s in queue) == sorted(b for b, _ in eng.dispatched)
    assert all(s["thread"] == "batcher-worker" for s in queue)
    inflight = [s for s in spans if s["name"] == "batcher.inflight_wait"]
    assert len(inflight) == 5 and {s["thread"] for s in inflight} == {"batcher-worker"}
    # five batches, two in flight at most, each fetch 50 ms: the worker waits
    assert max(s["end_ns"] - s["start_ns"] for s in inflight) > 20e6
    collect = [s for s in spans if s["name"] == "batcher.collect"]
    assert sorted(s["batch"] for s in collect) == [0, 1, 2, 3, 4]


def test_batcher_queue_spans_match_their_batches_at_depth_1(traced):
    eng = FakeEngine(B=2)
    batcher = MicroBatcher(eng, batch_wait_ms=20.0, pipeline_depth=1)
    assert sorted(submit_all(batcher, 5)) == [0, 1, 2, 3, 4]
    batcher.close()
    spans = tlog.trace_drain()["spans"]
    queue = [s for s in spans if s["name"] == "batcher.queue"]
    per_batch = {}
    for s in queue:
        per_batch[s["batch"]] = per_batch.get(s["batch"], 0) + 1
    assert per_batch == {b: n for b, n in eng.dispatched}
    dispatch = [s for s in spans if s["name"] == "batcher.dispatch"]
    assert sorted(s["batch"] for s in dispatch) == sorted(per_batch)


def test_train_step_spans_in_order(traced):
    step, params, batch = tiny_step()
    step(params, {}, batch)
    whole, *spans = tlog.trace_drain()["spans"]
    assert whole["name"] == "step" and whole["parent"] is None
    assert names({"spans": spans}) == ["stem", "step.forward", "step.backward", "step.update"]
    assert all(s["parent"] == whole["id"] for s in spans)
    assert all(a["end_ns"] <= b["start_ns"] for a, b in zip(spans, spans[1:]))
    assert whole["start_ns"] <= spans[0]["start_ns"] and spans[-1]["end_ns"] <= whole["end_ns"]


def test_device_prefetch_records_one_pin_per_batch(traced):
    got = list(device_prefetch(range(3), lambda k: ({"x": torch.full((2,), k)}, k), "cpu"))
    assert [k for _, k in got] == [0, 1, 2]
    assert names(tlog.trace_drain()) == ["prefetch.pin"] * 3


def test_program_and_benchmark_spans_share_one_clock(traced):
    """A program span opened inside a benchmark span lies within it, and an
    idle gap of the card inside the program span is named by it and its
    thread."""
    from vnqa_bench.trace import Trace, Window

    with Window(False, lambda: None) as w:
        def worker():
            with w.span("dispatch_batch"):
                time.sleep(0.002)
                with tlog.span("engine.make_batch"):
                    time.sleep(0.02)
                time.sleep(0.002)

        t = threading.Thread(target=worker, name="batcher-worker")
        t.start()
        t.join(10)
        w.close()
    assert not t.is_alive()
    (bench,) = w.spans
    (prog,) = tlog.trace_drain()["spans"]
    a, b = prog["start_ns"] * 1e-9, prog["end_ns"] * 1e-9
    assert bench[1] <= a < b <= bench[2] and w.lo <= bench[1]
    host = w.spans + [(f"{prog['name']} [{prog['thread']}]", a, b)]
    trace = Trace([("k1", w.lo, a + 1e-3), ("k2", b - 1e-3, w.hi)], host, w.lo, w.hi)
    (gap_name, _), *_ = trace.breakdown()["idle_gaps"]
    assert gap_name == "host: engine.make_batch [batcher-worker]"
