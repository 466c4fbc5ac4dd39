"""Starting a host's ranks: one process per device, with the ``spawn`` start
method (a forked child of a CUDA context can deadlock).

``spawn_ranks`` starts ranks in child processes; ``join`` waits for them
until a deadline and kills them past it; ``kill`` ends them at once. A
child that raises or dies fails the join. ``free_port`` is a port on
127.0.0.1 nobody holds (bound to port 0, then released).
"""

from __future__ import annotations

import contextlib
import os
import socket
import sys
import time

import torch
import torch.multiprocessing as tmp

# torch threads of a rank that computes on the CPU: the ranks share the cores
CPU_RANK_THREADS = 2


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def cpu_threads(n=CPU_RANK_THREADS):
    """torch's intra-op threads capped at ``n`` in the block."""
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, n))
    try:
        yield
    finally:
        torch.set_num_threads(old)


def _child(i, target, first, quiet, args):
    if quiet:
        sys.stdout = open(os.devnull, "w")
    target(first + i, *args)


def spawn_ranks(target, args, *, nprocs, first=1, quiet=True):
    """Start ``target(first + i, *args)`` for i < ``nprocs`` in spawned
    processes -> their context for ``join`` and ``kill``. ``target`` and
    ``args`` must pickle (a module-level function). ``quiet``: the
    children's standard output goes nowhere."""
    return tmp.start_processes(_child, args=(target, first, quiet, args), nprocs=nprocs,
                               join=False, start_method="spawn")


def join(procs, timeout_s):
    """Wait for every process of ``procs`` to end. Raises at once where one
    raised or died (the others are killed); past ``timeout_s`` kills them
    all and raises TimeoutError."""
    deadline = time.monotonic() + timeout_s
    while not procs.join(timeout=max(0.05, min(1.0, deadline - time.monotonic()))):
        if time.monotonic() > deadline:
            kill(procs)
            raise TimeoutError(f"{len(procs.processes)} ranks did not end within {timeout_s} s")


def kill(procs):
    for p in procs.processes:
        if p.is_alive():
            p.kill()
    for p in procs.processes:
        p.join(timeout=30)
