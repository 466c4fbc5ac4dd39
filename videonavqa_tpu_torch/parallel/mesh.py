"""Device mesh and sharding rules (the port of the JAX package's parallel/mesh.py).

A 2-axis ('data', 'model') mesh. Batches shard over 'data'; params
replicate, except the widest projections, whose output rows may shard over
'model' (``DEFAULT_MODEL_SHARDED``). The layout is the JAX package's
``reshape(n // mp, mp)``: rank = d * mp + m, one data group per m (the ranks
that hold the same shard of every weight) and one model group per d (the
ranks that hold the same rows of every batch).

A mesh is driven one of two ways:

- one process per device (the training harness): torch.distributed spans
  the mesh, this process is one rank, ``mesh.ranks`` holds its one
  ``MeshRank``; ``multihost.initialize`` joins the group first;
- one thread per device in one process (serving, and tests that pass
  ``devices``): ``mesh.ranks`` holds every rank, whose groups are
  ``collectives.ThreadGroup``s; the caller runs each rank in a thread of
  its own under ``collectives.thread_rank``.

What GSPMD does in the JAX package the port does in ``collectives.py``.
"""

from __future__ import annotations

import dataclasses
import os
import re

import torch
import torch.distributed as dist

from videonavqa_tpu_torch.parallel import collectives


@dataclasses.dataclass
class MeshRank:
    """One rank of a mesh: its coordinates, its device and its groups."""
    shape: dict
    rank: int
    data_index: int
    model_index: int
    device: torch.device
    data: object      # the ranks with this model index (a batch's every row)
    model: object     # the ranks with this data index (a weight's every shard)
    world: object


@dataclasses.dataclass
class Mesh:
    shape: dict               # {"data": dp, "model": mp}
    devices: list             # one device per rank, in rank order
    ranks: list               # the MeshRanks this process drives
    process: bool             # True: one process per device

    @property
    def size(self):
        return self.shape["data"] * self.shape["model"]

    @property
    def local(self):
        """This process's rank of a one-process-per-device mesh."""
        if not self.process:
            raise ValueError("a single-process mesh has a rank per thread")
        return self.ranks[0]


def local_devices(device_type=None):
    """The devices of this host: the cards, or where there is none (or
    ``device_type`` is 'cpu'), the CPU once per core."""
    if device_type != "cpu" and torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")] * (os.cpu_count() or 1)


def _check(n, model_parallel, have, where):
    if n is not None and have < n:
        raise ValueError(f"requested a {n}-device mesh but only {have} device(s) exist "
                         f"({where}); start more ranks or name the devices")
    n = have if n is None else n
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    return n


def make_mesh(n_devices=None, model_parallel=1, devices=None) -> Mesh:
    """The mesh of ``n_devices`` (default: all) x ``model_parallel``.

    Without ``devices``, inside an initialized torch.distributed group, the
    mesh is the group's ranks, one device each (this rank's is
    ``multihost.rank_device()``); every rank must call this, as it creates
    the data and model groups. Otherwise it is a
    single-process mesh over ``devices`` (default: ``local_devices()``).
    Raises when fewer devices exist than asked, as the JAX package's does."""
    mp = model_parallel
    if devices is None and dist.is_available() and dist.is_initialized():
        from videonavqa_tpu_torch.parallel import multihost

        world = dist.get_world_size()
        n = _check(n_devices, mp, world, "ranks in the process group")
        if n != world:
            raise ValueError(f"a {n}-device mesh needs a process group of {n} ranks, one a "
                             f"device; this one has {world}")
        dp, me = n // mp, dist.get_rank()
        data_groups = [list(range(m, n, mp)) for m in range(mp)]
        model_groups = [list(range(d * mp, (d + 1) * mp)) for d in range(dp)]
        made = {}
        for ranks in data_groups + model_groups:   # every rank creates every group
            made[tuple(ranks)] = dist.new_group(ranks)
        d, m = divmod(me, mp)
        rank = MeshRank(
            shape={"data": dp, "model": mp}, rank=me, data_index=d, model_index=m,
            device=multihost.rank_device(),
            data=collectives.ProcessGroup(made[tuple(data_groups[m])], data_groups[m], d),
            model=collectives.ProcessGroup(made[tuple(model_groups[d])], model_groups[d], m),
            world=collectives.ProcessGroup(None, range(n), me))
        return Mesh(rank.shape, [None] * n, [rank], process=True)

    devices = list(devices if devices is not None else local_devices())
    n = _check(n_devices, mp, len(devices), f"{len(devices)} named or local")
    devices, dp = [torch.device(d) for d in devices[:n]], n // mp
    data_groups = [collectives.ThreadGroup(dp) for _ in range(mp)]
    model_groups = [collectives.ThreadGroup(mp) for _ in range(dp)]
    world = collectives.ThreadGroup(n)
    ranks = [MeshRank(shape={"data": dp, "model": mp}, rank=r, data_index=r // mp,
                      model_index=r % mp, device=devices[r],
                      data=data_groups[r % mp].member(r // mp),
                      model=model_groups[r // mp].member(r % mp), world=world.member(r))
             for r in range(n)]
    mesh = Mesh({"data": dp, "model": mp}, devices, ranks, process=False)
    mesh.thread_groups = data_groups + model_groups + [world]
    return mesh


def batch_sharding(rank: MeshRank):
    """x -> ``rank``'s rows of x (a leaf's leading dim split over 'data');
    a scalar passes whole. (Here and below ``rank`` is one rank of a mesh:
    ``mesh.local``, or one of a single-process mesh's ``ranks``.)"""
    dp = rank.shape["data"]

    def spec(x):
        if x.ndim < 1:
            return x
        per = x.shape[0] // dp
        return x[rank.data_index * per:(rank.data_index + 1) * per]

    return spec


def shard_batch(batch, rank: MeshRank):
    """A global host batch -> ``rank``'s rows of every leaf, on its device."""
    spec = batch_sharding(rank)
    return {k: spec(v).to(rank.device) for k, v in batch.items()}


def put_global(tree, shardings, rank: MeshRank):
    """Each leaf of the identical full host copy (the same seeded init or
    checkpoint file on every rank) -> ``rank``'s part on its device: the
    rows of its model index for a leaf sharded over 'model' (marked so, for
    ``ops.linear``), the whole leaf otherwise."""
    mp = rank.shape["model"]
    specs = dict(_items(shardings))

    def one(path, t):
        if specs.get(path) == ("model", None):
            rows = t.shape[0] // mp
            part = t.detach()[rank.model_index * rows:(rank.model_index + 1) * rows]
            out = part.to(rank.device, copy=True).contiguous()
            return collectives.mark_model_sharded(out, rank.model_index, mp)
        return t.detach().to(rank.device, copy=True)

    return _map_items(one, tree)


def replicate(tree, rank: MeshRank):
    """``tree`` on ``rank``'s device, broadcast from rank 0 over the mesh
    (one flat buffer a dtype)."""
    out = {p: t.detach().to(rank.device, copy=True) for p, t in _items(tree)}
    by_dtype = {}
    for p, t in out.items():
        by_dtype.setdefault(t.dtype, []).append(p)
    for dtype, paths in by_dtype.items():
        flat = torch.cat([out[p].reshape(-1) for p in paths])
        rank.world.broadcast_(flat, 0)
        at = 0
        for p in paths:
            out[p] = flat[at:at + out[p].numel()].view(out[p].shape).clone()
            at += out[p].numel()
    return _map_items(lambda p, t: out[p], tree)


def _items(tree):
    """[(path, leaf)] as train/step.py tree_items names them."""
    out = []
    _map_items(lambda p, t: out.append((p, t)), tree)
    return out


def _map_items(fn, tree, prefix=""):
    if isinstance(tree, dict):
        return {k: _map_items(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_items(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


# Leaves whose *output* rows shard over 'model', as regexes over the '/'-joined
# paths of train/step.py tree_items (the JAX package's six).
DEFAULT_MODEL_SHARDED = (
    r".*fc6/weight$",            # 7680 x 2048 (v_only_cnn3d / concat3d)
    r".*decoder/weight$",        # FiLM hidden -> 2*C*N
    r".*fc_attn_out/weight$",    # time_multi_hop decoder
    r".*out_linear/weight$",
    r".*read_concat/weight$",    # MAC read unit
    r".*write_concat/weight$",
)


def param_shardings(params, mesh, *, model_parallel_rules=DEFAULT_MODEL_SHARDED):
    """A tree of specs like ``params``: ``("model", None)`` for a matched 2-D
    weight whose rows divide by the model axis (dim 0, torch's [out, in]),
    ``()`` (replicated) for every other leaf. ``mesh``: a Mesh or a MeshRank
    (only its shape is read).

    Adam's moments follow these shardings by construction, where the JAX
    package needs ``opt_state_shardings``: the optimizer is made over this
    rank's placed leaves (a 'model'-sharded leaf's rows), and its moments
    take their shapes."""
    mp = mesh.shape["model"]
    patterns = [re.compile(p) for p in model_parallel_rules]

    def one(path, leaf):
        if mp > 1 and leaf.ndim == 2 and leaf.shape[0] % mp == 0 \
                and any(p.match(path) for p in patterns):
            return ("model", None)
        return ()

    return _map_items(one, params)

