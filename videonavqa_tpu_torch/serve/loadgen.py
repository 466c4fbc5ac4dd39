"""A closed-loop HTTP load generator for the serving daemon (stdlib only).

``clients`` threads each send one ``POST /predict`` at a time, taking job
after job from a shared list, until ``n`` are sent; with ``until_file`` they
go on past ``n`` (through the rest of the list) until that file exists. Run
it as a process of its own, so that its interpreter lock is not the
daemon's:

    python -m videonavqa_tpu_torch.serve.loadgen --port 8808 --jobs jobs.json \\
        --n 256 --clients 64 [--until_file stop]

``jobs.json`` is a list of ``{"example": id, "question": text}`` (or
``"video"``) bodies. It prints one JSON object: ``{"wall_s": seconds,
"results": [[job index, status, body], ...]}``; the status is null where the
server took no connection.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import threading
import time
import urllib.error
import urllib.request


def request(port, path, payload=None, timeout=300):
    """(status, JSON body) of one request; (None, error text) where the
    server took no connection."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())
    except (urllib.error.URLError, ConnectionError) as e:
        return None, str(e)


def run(port, jobs, n, clients, until_file=None):
    """-> (wall s, [(job index, status, body)] in the order answered)."""
    nxt = itertools.count()
    results, lock = [], threading.Lock()

    def client():
        while True:
            i = next(nxt)
            if i >= len(jobs) or (i >= n and (until_file is None or
                                             os.path.exists(until_file))):
                return
            status, body = request(port, "/predict", jobs[i])
            with lock:
                results.append((i, status, body))

    threads = [threading.Thread(target=client) for _ in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return time.perf_counter() - t0, results


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--port", type=int, required=True)
    parser.add_argument("--jobs", type=str, required=True)
    parser.add_argument("--n", type=int, required=True)
    parser.add_argument("--clients", type=int, default=64)
    parser.add_argument("--until_file", type=str, default=None)
    args = parser.parse_args(argv)
    with open(args.jobs) as f:
        jobs = json.load(f)
    wall, results = run(args.port, jobs, args.n, args.clients, args.until_file)
    print(json.dumps({"wall_s": wall, "results": results}))


if __name__ == "__main__":
    main()
