"""The daemon's HTTP surface (the port of the JAX package's ``cli/serve.py``
make_handler): the same paths, bodies, status codes, ``/stats`` keys and
Prometheus names.

    POST /predict   {"video": "<path, relative to videos/ or absolute>",
                     "question": "..."}  or, over a feature cache,
                    {"example": "<example id>", "question": "..."}
      -> {"answer": str, "top": [[answer, prob] x5]}
    GET  /healthz   -> {"ok": true, "pending": n, "epoch": e}
    GET  /stats     -> {"requests", "batches", "errors", "deferred", "rejected",
                        "forward_s", "avg_batch", "avg_forward_ms",
                        "latency_p50_ms", "latency_p95_ms", "latency_p99_ms",
                        "weights_version", "int8_calibration_pending",
                        "stem_fingerprint" (feature cache), "pending"}
    GET  /metrics   -> the same in Prometheus text (videonavqa_* names)
    POST /reload    {"checkpoint_path": "<optional new .npz>"}

A bad request is a 400 (a reload that fails too: the old weights keep
serving), an unknown path a 404, a failed forward a 500 and a request past
``max_pending`` a 503.
"""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler

import numpy as np

from videonavqa_tpu_torch.datagen.ontology import ANSWER_VOCAB
from videonavqa_tpu_torch.serve.batcher import Overloaded

CLASS_TO_ANSWER = {v: k for k, v in ANSWER_VOCAB.items()}


def stats(engine, batcher):
    """The /stats dictionary."""
    with batcher._lock:
        s = dict(batcher.stats)
        lats = list(batcher._latencies)
    s["avg_batch"] = s["requests"] / s["batches"] if s["batches"] else 0.0
    s["avg_forward_ms"] = s["forward_s"] / s["batches"] * 1e3 if s["batches"] else 0.0
    if lats:   # end-to-end request latency over the last <= 1024 requests
        q = np.quantile(lats, [0.5, 0.95, 0.99])
        s["latency_p50_ms"] = float(q[0]) * 1e3
        s["latency_p95_ms"] = float(q[1]) * 1e3
        s["latency_p99_ms"] = float(q[2]) * 1e3
    with engine._weights_lock:
        s["weights_version"] = engine._weights_version
        s["int8_calibration_pending"] = engine._needs_int8_calibration
    if getattr(engine, "stem_fingerprint_hex", None):
        s["stem_fingerprint"] = engine.stem_fingerprint_hex
    s["pending"] = batcher.pending()
    return s


def prometheus(s):
    """The /metrics text of a /stats dictionary."""
    lines = []

    def metric(name, kind, value):
        lines.append(f"# TYPE videonavqa_{name} {kind}")
        lines.append(f"videonavqa_{name} {value}")

    metric("requests_total", "counter", s["requests"])
    metric("batches_total", "counter", s["batches"])
    metric("errors_total", "counter", s["errors"])
    metric("rejected_total", "counter", s["rejected"])
    metric("deferred_total", "counter", s["deferred"])
    metric("forward_seconds_total", "counter", s["forward_s"])
    metric("pending_requests", "gauge", s["pending"])
    metric("avg_batch_size", "gauge", s["avg_batch"])
    metric("weights_version", "gauge", s["weights_version"])
    lines.append("# TYPE videonavqa_request_latency_seconds summary")
    for p in ("50", "95", "99"):
        v = s.get(f"latency_p{p}_ms")
        if v is not None:
            lines.append('videonavqa_request_latency_seconds{quantile="0.%s"} %g' % (p, v / 1e3))
    return "\n".join(lines) + "\n"


def make_handler(engine, batcher):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_json(self, default=None):
            """The request body as a dict; ValueError (400) on anything else."""
            n = int(self.headers.get("Content-Length", 0))
            if not n and default is not None:
                return default
            req = json.loads(self.rfile.read(n))
            if not isinstance(req, dict):
                raise ValueError("request body must be a JSON object")
            return req

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"ok": True, "pending": batcher.pending(),
                                 "epoch": engine.epoch})
            elif self.path == "/stats":
                self._send(200, stats(engine, batcher))
            elif self.path == "/metrics":
                body = prometheus(stats(engine, batcher)).encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path == "/reload":
                # in-flight batches finish on the old weights; the next
                # micro-batch serves the new ones
                try:
                    req = self._read_json(default={})
                    epoch = engine.reload(req.get("checkpoint_path"))
                    self._send(200, {"ok": True, "epoch": epoch})
                except Exception as e:
                    self._send(400, {"error": str(e)})
                return
            if self.path != "/predict":
                self._send(404, {"error": "unknown path"})
                return
            try:
                req = self._read_json()
                tokens = engine.encode_question(req["question"])
                if "example" in req:
                    frames, v_len = engine.load_example(req["example"])
                else:
                    frames, v_len = engine.load_video(req["video"])
            except (ValueError, KeyError, OSError) as e:
                self._send(400, {"error": str(e)})
                return
            try:
                probs = batcher.submit(frames, v_len, tokens)
            except Overloaded as e:
                self._send(503, {"error": f"overloaded: {e}"})
                return
            except Exception as e:   # a failed forward still gets a response
                self._send(500, {"error": f"inference failed: {e}"})
                return
            top = np.argsort(-probs)[:5]
            self._send(200, {"answer": CLASS_TO_ANSWER[int(top[0])],
                             "top": [[CLASS_TO_ANSWER[int(i)], float(probs[i])] for i in top]})

        def log_message(self, fmt, *a):   # no access log
            pass

    return Handler
