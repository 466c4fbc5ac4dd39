"""The micro-batcher: concurrent requests into one forward call (the port of
the JAX package's ``cli/serve.py`` MicroBatcher).

A worker thread collects up to ``max_batch`` requests, or what arrived within
``batch_wait_ms`` of the first (an absolute deadline), and runs them through
one padded forward. With frame buckets, dispatch is bucket-aware: where the
backlog (looked at up to 4 x max_batch deep) lets the oldest request's bucket
fill a whole batch, that bucket goes pure and the rest wait for the next
round; where it cannot, the batch goes mixed, as without buckets (splitting
an underfull batch only multiplies fixed costs). A request carried over
counts once in ``deferred``. Past ``max_pending`` outstanding requests,
``submit`` raises ``Overloaded`` (HTTP 503).

At ``pipeline_depth`` >= 2 the worker only dispatches each batch
(``engine.dispatch_batch``: staged, copied and enqueued) and hands it to a
completion thread that waits for its probabilities (``engine.fetch``), so
the next batch's staging and copy overlap this batch's forward; a semaphore
bounds the batches dispatched and not yet fetched. ``close`` ends both
threads once the requests queued before it are answered.

The threads are named ``batcher-worker`` and ``batcher-completer``. While
tracing is on (``utils/logging.py``) the worker records ``batcher.collect``
(from the first request in hand to the dispatch decision),
``batcher.inflight_wait`` (blocked on the semaphore: the card paces the
batcher) and ``batcher.dispatch`` (the engine's call, whose spans take its
batch id), and each request a ``batcher.queue`` wait from ``submit``
queueing it to the collect that returns it in a batch (carry-overs
included), all under the batch's number.
"""

from __future__ import annotations

import collections
import itertools
import queue
import threading
import time

from videonavqa_tpu_torch.utils.logging import span, tracing, wait_span


class Overloaded(RuntimeError):
    """Raised by MicroBatcher.submit past max_pending; maps to HTTP 503."""


_STOP = object()   # queued by close(): the worker, then the completion thread, end


class MicroBatcher:
    """Collects concurrent requests into one forward call (see the module)."""

    def __init__(self, engine, batch_wait_ms=5.0, max_pending=512, pipeline_depth=1):
        self.engine = engine
        self.wait_s = batch_wait_ms / 1e3
        self.max_pending = max_pending
        self.q = queue.Queue()
        self._carry = []
        self._outstanding = 0
        self.stats = {"requests": 0, "batches": 0, "errors": 0,
                      "deferred": 0, "rejected": 0, "forward_s": 0.0}
        # end-to-end request latencies (submit -> response), the last 1024
        self._latencies = collections.deque(maxlen=1024)
        self._lock = threading.Lock()
        self._request_ids = itertools.count()   # the spans' request id
        self._cq = None
        if pipeline_depth > 1:
            self._cq = queue.Queue()
            self._inflight = threading.Semaphore(pipeline_depth)
            self._completer = threading.Thread(target=self._complete, daemon=True,
                                               name="batcher-completer")
            self._completer.start()
        self._worker = threading.Thread(target=self._loop, daemon=True, name="batcher-worker")
        self._worker.start()

    def submit(self, frames, v_len, tokens):
        """Blocking: this request's probability vector. Raises Overloaded
        past ``max_pending`` outstanding requests (each pins MBs of frames)."""
        with self._lock:
            if self._outstanding >= self.max_pending:
                self.stats["rejected"] += 1
                raise Overloaded(f"{self._outstanding} requests already pending")
            self._outstanding += 1
        try:
            t0 = time.monotonic()
            done = threading.Event()
            slot = {}
            if tracing():
                slot["_queued"] = (next(self._request_ids), time.time_ns())
            self.q.put(((frames, v_len, tokens), slot, done))
            done.wait()
            if "error" in slot:
                raise slot["error"]
            with self._lock:
                self._latencies.append(time.monotonic() - t0)
            return slot["probs"]
        finally:
            with self._lock:
                self._outstanding -= 1

    def pending(self):
        """Outstanding requests: queued, carried and inside a running forward."""
        return self._outstanding

    def close(self, timeout=60.0):
        """End the worker and completion threads after the requests queued
        before this call are answered."""
        self.q.put(_STOP)
        self._worker.join(timeout)
        if self._cq is not None:
            self._completer.join(timeout)

    def _collect(self, bid):
        """The next micro-batch of queued (item, slot, done) requests, batch
        number ``bid`` in the spans."""
        batch = self._carry
        self._carry = []
        if not batch:
            first = self.q.get()
            if first is _STOP:
                return None
            batch = [first]
        with span("batcher.collect", batch=bid):
            dispatch = self._fill(batch)
        if tracing():
            for _, slot, _ in dispatch:
                if "_queued" in slot:
                    request, queued = slot["_queued"]
                    wait_span("batcher.queue", queued, request=request, batch=bid)
        return dispatch

    def _fill(self, batch):
        """The micro-batch to dispatch from the requests in hand and those
        queued behind them; the rest carry over."""
        B = self.engine.B
        # an absolute deadline from the first request (per-get timeouts would
        # stretch the window to (B-1) x wait under a trickle of arrivals)
        deadline = time.monotonic() + self.wait_s
        while len(batch) < B:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self.q.get(timeout=remaining)
            except queue.Empty:
                break
            if item is _STOP:   # dispatch what came before it, then stop
                self.q.put(item)
                return batch
            batch.append(item)
        if not self.engine.frame_buckets:
            return batch
        # at saturation, look past B into the backlog (already queued) so a
        # bucket group has a chance to fill a whole batch
        while len(batch) < 4 * B:
            try:
                item = self.q.get_nowait()
            except queue.Empty:
                break
            if item is _STOP:
                self.q.put(item)
                break
            batch.append(item)
        key = self.engine.bucket_for(batch[0][0][1])
        same = [r for r in batch if self.engine.bucket_for(r[0][1]) == key]
        if len(same) >= B:   # the oldest request's bucket fills a batch: go pure
            dispatch = same[:B]
            picked = set(map(id, dispatch))
            self._carry = [r for r in batch if id(r) not in picked]
        else:                # it cannot: one mixed batch
            dispatch, self._carry = batch[:B], batch[B:]
        if self._carry:
            with self._lock:
                for _, slot, _ in self._carry:
                    if not slot.get("_deferred"):   # once per request
                        slot["_deferred"] = True
                        self.stats["deferred"] += 1
        return dispatch

    def _loop(self):
        for bid in itertools.count():
            batch = self._collect(bid)
            if batch is None:
                if self._cq is not None:
                    self._cq.put(_STOP)
                return
            items = [b[0] for b in batch]
            t0 = time.time()
            if self._cq is None:   # pipeline_depth 1: synchronous
                try:
                    with span("batcher.dispatch", batch=bid):
                        probs = self.engine.run_batch(items)
                except Exception as e:
                    self._fail(batch, e)
                else:
                    self._settle(batch, probs, t0)
                continue
            with span("batcher.inflight_wait", batch=bid):
                self._inflight.acquire()
            try:
                with span("batcher.dispatch", batch=bid):
                    handle = self.engine.dispatch_batch(items)
            except Exception as e:
                self._inflight.release()
                self._fail(batch, e)
            else:
                self._cq.put((batch, handle, t0))

    def _settle(self, batch, probs, t0):
        """Deliver one micro-batch's probabilities to its waiters."""
        for i, (_, slot, done) in enumerate(batch):
            slot["probs"] = probs[i]
            done.set()
        with self._lock:
            self.stats["requests"] += len(batch)
            self.stats["batches"] += 1
            self.stats["forward_s"] += time.time() - t0

    def _fail(self, batch, e):
        """Surface one failure to every waiter in the batch."""
        for _, slot, done in batch:
            slot["error"] = e
            done.set()
        with self._lock:
            self.stats["errors"] += len(batch)

    def _complete(self):
        """Fetch each dispatched batch in dispatch order and deliver it; an
        error the card raises only at the fetch lands on the batch's waiters."""
        while True:
            job = self._cq.get()
            if job is _STOP:
                return
            batch, handle, t0 = job
            try:
                probs = self.engine.fetch(handle)
            except Exception as e:
                self._fail(batch, e)
            else:
                self._settle(batch, probs, t0)
            finally:
                self._inflight.release()
