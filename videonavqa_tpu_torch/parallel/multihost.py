"""Joining a mesh's process group, and each rank's slice of a batch (the port
of the JAX package's parallel/multihost.py).

One process drives one device. ``initialize`` joins torch.distributed: NCCL
for a card, gloo for the CPU, rendezvous at ``tcp://coordinator_address``,
or from torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``) when the arguments are None. A rank missing from
the rendezvous after ``RENDEZVOUS_S``, or from a collective after
``TIMEOUT_S``, fails the run. A rank's loader
decodes only its rows of each global batch (``host_batch_slice``), and its
rows are its whole batch on its device (``global_batch_from_host_shards``):
the global batch exists only across the ranks.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from videonavqa_tpu_torch.parallel import collectives

# a collective that waits longer than this on a peer fails the run
TIMEOUT_S = 600
# so does a rank that has not joined the rendezvous within this
RENDEZVOUS_S = 180

_device = None


def rank_device():
    """The device ``initialize`` gave this process (the CPU before it)."""
    return _device or torch.device("cpu")


def resolve(coordinator_address=None, num_processes=None, process_id=None):
    """(address, number of processes, process id): the arguments, or with all
    three None, torchrun's environment's where it names them all."""
    env = os.environ
    if coordinator_address is None and num_processes is None and process_id is None \
            and all(k in env for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")):
        return (f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}", int(env["WORLD_SIZE"]),
                int(env["RANK"]))
    return coordinator_address, num_processes, process_id


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               expect_multiprocess=False, backend=None, device=None):
    """Join the process group of ``num_processes`` ranks as rank
    ``process_id`` (one device each, ``device``: this rank's, default the
    CPU); ``backend``: NCCL for a card, gloo otherwise, by default. With all
    three None, torchrun's environment names them; with none there, the
    process stays alone. ``expect_multiprocess`` (the harness sets it for
    --distributed) raises where the group resolves to one process, unless
    one was asked for (``num_processes=1``): a host training alone while its
    peers do the same would give plausible numbers."""
    global _device
    device = torch.device(device or "cpu")
    coordinator_address, num_processes, process_id = resolve(
        coordinator_address, num_processes, process_id)
    if num_processes == 1 and process_id is None:
        process_id = 0
    if num_processes is not None and process_id is not None and not dist.is_initialized():
        if coordinator_address is None:
            if num_processes != 1:
                raise ValueError("--coordinator_address is needed for more than one process")
            from videonavqa_tpu_torch.parallel.launch import free_port

            coordinator_address = f"127.0.0.1:{free_port()}"
        if device.type == "cuda":
            torch.cuda.set_device(device)
        host, port = coordinator_address.rsplit(":", 1)
        store = dist.TCPStore(host, int(port), num_processes, is_master=process_id == 0,
                              timeout=datetime.timedelta(seconds=RENDEZVOUS_S))
        dist.init_process_group(
            backend or ("nccl" if device.type == "cuda" else "gloo"), store=store,
            world_size=num_processes, rank=process_id,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
        _device = device
    world = dist.get_world_size() if dist.is_initialized() else 1
    if expect_multiprocess and num_processes != 1 and world == 1:
        raise RuntimeError(
            "--distributed was requested but the process group resolved to a single "
            "process: this host would silently train alone while its peers do the same. "
            "Pass explicit --coordinator_address/--num_processes/--process_id (or "
            "--num_processes 1 / drop --distributed if one process is intended).")


def shutdown():
    """Leave the process group, where this process joined one."""
    global _device
    if dist.is_initialized():
        dist.destroy_process_group()
    _device = None


def host_batch_slice(global_batch_size: int, rank=None):
    """(start, size) of ``rank``'s (default: the active rank's) rows of the
    global batch: its data index's share."""
    rank = rank or collectives.current()
    n = rank.shape["data"] if rank is not None else 1
    i = rank.data_index if rank is not None else 0
    assert global_batch_size % n == 0, \
        f"global batch {global_batch_size} not divisible by {n} data ranks"
    per = global_batch_size // n
    return i * per, per


def global_batch_from_host_shards(rank, host_batch):
    """``rank``'s rows (its loader's shard) as its share of the global
    batch, on its device: {key: tensor}."""
    return {k: torch.as_tensor(np.ascontiguousarray(v)).to(rank.device)
            for k, v in host_batch.items()}
