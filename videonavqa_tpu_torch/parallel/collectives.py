"""The collectives of a device mesh, written out.

The JAX package gets them from GSPMD: params replicated and batches sharded
over 'data', XLA inserts the gradient psum and makes every reduction over
the batch a cross-device one, so sharded training gives one device's
numbers. PyTorch inserts nothing, so the port calls these helpers where it
reduces over the batch, and the train step calls ``sum_grads_over_data``.

The active mesh rank (``mesh.MeshRank``: this rank's coordinates, device and
groups) is held here: process-wide for the training harness (one process
per device), or per thread for a single-process serving mesh (one thread per
device). With no mesh active every helper is the identity, so one-device
code and numbers do not change.

- ``sum_over_batch`` / ``max_over_batch``: a reduction over the 'data' axis.
  A sum that carries a gradient goes through an autograd all-reduce whose
  backward all-reduces the gradient: each rank's loss is its own rows'
  part, so the gradient of a shared statistic is the sum of every rank's
  part, as SyncBatchNorm computes it.
- ``batch_rows``: a draw over the batch's rows is made at the global shape
  on every rank (each seeds its generator alike) and each takes its rows.
- ``global_value``: a loss whose value is the global one while its gradient
  is this rank's part (its rows' sum over the global divisor).
- ``sum_grads_over_data``: one flat buffer of every gradient summed over
  'data' (DistributedDataParallel averages, and wants an nn.Module).
- ``enter_model_columns`` / ``gather_model_columns``: a Linear whose weight
  rows are split over 'model' computes its columns and all-gathers them;
  the input's gradient is all-reduced over 'model' on the way back (each
  model rank sees the whole gradient of the gathered output, and its input
  gradient from its own columns only).

Groups are ``ProcessGroup`` (torch.distributed: NCCL on the card, gloo on
the CPU) or ``ThreadGroup`` (a barrier among the threads of one process).
Both reduce in rank order, so every rank gets the same bits.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist

_local = threading.local()
_process_rank = None

# the tensor attribute that marks a weight whose rows are split over 'model':
# (this rank's model index, the model axis size)
SHARD_ATTR = "_model_shard"

# a ThreadGroup member waits this long at a barrier before it gives up
THREAD_TIMEOUT_S = 600.0


def current():
    """The active ``MeshRank`` of this thread, else of this process, else None."""
    rank = getattr(_local, "rank", None)
    return rank if rank is not None else _process_rank


def set_process_rank(rank):
    """Make ``rank`` (or None) the process's active mesh rank."""
    global _process_rank
    _process_rank = rank


@contextlib.contextmanager
def thread_rank(rank):
    """Make ``rank`` the active mesh rank of the calling thread in the block."""
    prev = getattr(_local, "rank", None)
    _local.rank = rank
    try:
        yield rank
    finally:
        _local.rank = prev


# --- groups -------------------------------------------------------------------

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class ProcessGroup:
    """A torch.distributed group seen from one member."""

    def __init__(self, pg, ranks, index):
        self.pg, self.ranks, self.index, self.size = pg, list(ranks), index, len(ranks)

    def all_reduce(self, t, op="sum"):
        out = t.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=_OPS[op], group=self.pg)
        return out

    def all_gather(self, t, dim):
        t = t.detach().contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.pg)
        return torch.cat(parts, dim=dim)

    def all_gather_object(self, obj):
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.pg)
        return out

    def broadcast_(self, t, src_index=0):
        dist.broadcast(t, src=self.ranks[src_index], group=self.pg)
        return t


class ThreadGroup:
    """The threads of one process that drive a group's devices: each member
    posts its tensor, and after a barrier every member folds all of them in
    rank order on its own device."""

    def __init__(self, size):
        self.size = size
        self._slots = [None] * size
        self._barrier = threading.Barrier(size, timeout=THREAD_TIMEOUT_S)

    def member(self, index):
        return ThreadMember(self, index)

    def abort(self):
        """Release every member waiting at the barrier with an error."""
        self._barrier.abort()

    def reset(self):
        """Ready the group for use again after an ``abort``."""
        self._barrier.reset()

    def exchange(self, index, value):
        self._slots[index] = value
        self._barrier.wait()
        got = list(self._slots)
        self._barrier.wait()
        return got


class ThreadMember:
    def __init__(self, group, index):
        self.group, self.index, self.size = group, index, group.size

    def all_reduce(self, t, op="sum"):
        parts = [p.to(t.device) for p in self.group.exchange(self.index, t.detach())]
        out = parts[0].clone()
        for p in parts[1:]:
            out = out + p if op == "sum" else torch.maximum(out, p)
        return out

    def all_gather(self, t, dim):
        return torch.cat([p.to(t.device) for p in self.group.exchange(self.index, t.detach())],
                         dim=dim)

    def all_gather_object(self, obj):
        return self.group.exchange(self.index, obj)


# --- reductions over the batch --------------------------------------------------

class _SumWithGrad(torch.autograd.Function):
    """All-reduce sum whose backward all-reduces the gradient."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return group.all_reduce(x, "sum")

    @staticmethod
    def backward(ctx, grad):
        return None, ctx.group.all_reduce(grad, "sum")


def sum_over_batch(x):
    """``x`` (this rank's rows' partial sum) summed over the 'data' axis."""
    rank = current()
    if rank is None:
        return x
    if x.requires_grad and torch.is_grad_enabled():
        return _SumWithGrad.apply(rank.data, x)
    return rank.data.all_reduce(x, "sum")


def max_over_batch(x):
    """``x`` (this rank's rows' max) maxed over the 'data' axis; no gradient."""
    rank = current()
    return x if rank is None else rank.data.all_reduce(x, "max")


def global_value(local_part):
    """A scalar whose value is ``local_part`` summed over 'data' and whose
    gradient is ``local_part``'s own."""
    rank = current()
    if rank is None:
        return local_part
    return local_part + (rank.data.all_reduce(local_part, "sum") - local_part).detach()


def batch_rows(local_rows):
    """(global row count, this rank's first row) of a draw over ``local_rows``
    rows of this rank's batch."""
    rank = current()
    if rank is None:
        return local_rows, 0
    return local_rows * rank.shape["data"], local_rows * rank.data_index


def take_rows(t, local_rows, dim=0):
    """This rank's ``local_rows`` of a draw ``t`` made at the global shape
    (``t`` itself without a mesh)."""
    if current() is None:
        return t
    _, start = batch_rows(local_rows)
    return t.narrow(dim, start, local_rows)


# --- gradients -----------------------------------------------------------------

def sum_grads_over_data(grads):
    """The gradients summed over 'data' through one flat f32 buffer."""
    rank = current()
    if rank is None or not grads:
        return grads
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    flat = rank.data.all_reduce(flat, "sum")
    out, at = [], 0
    for g in grads:
        out.append(flat[at:at + g.numel()].view(g.shape).to(g.dtype))
        at += g.numel()
    return out


def sum_over_model(x):
    """``x`` summed over the 'model' axis (no gradient)."""
    rank = current()
    return x if rank is None else rank.model.all_reduce(x, "sum")


# --- the model axis ---------------------------------------------------------------

def is_model_sharded(t):
    return getattr(t, SHARD_ATTR, None) is not None


def mark_model_sharded(t, index, size):
    setattr(t, SHARD_ATTR, (index, size))
    return t


def like_sharded(view, src):
    """``view`` (columns of ``src``) marked as ``src`` is."""
    shard = getattr(src, SHARD_ATTR, None)
    if shard is not None:
        setattr(view, SHARD_ATTR, shard)
    return view


class _EnterModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return None, ctx.group.all_reduce(grad, "sum")


class _GatherColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, y):
        ctx.group, ctx.cols = group, y.shape[-1]
        return group.all_gather(y, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        i, n = ctx.group.index, ctx.cols
        return None, grad[..., i * n:(i + 1) * n].contiguous()


def enter_model_columns(x, weight):
    """The input of a Linear on ``weight``: as it is, unless ``weight`` is
    'model'-sharded and the gradient is taken, where its gradient comes back
    all-reduced over 'model'."""
    rank = current()
    if rank is None or not is_model_sharded(weight):
        return x
    if x.requires_grad and torch.is_grad_enabled():
        return _EnterModel.apply(rank.model, x)
    return x


def gather_model_columns(y, weight):
    """A Linear's output columns from a 'model'-sharded ``weight``, gathered
    over 'model' into the whole output; as it is otherwise."""
    rank = current()
    if rank is None or not is_model_sharded(weight):
        return y
    if torch.is_grad_enabled() and y.requires_grad:
        return _GatherColumns.apply(rank.model, y)
    return rank.model.all_gather(y, dim=-1)


def full_leaf(t, like=None):
    """The whole of a leaf whose rows are split over 'model' (``like``: the
    parameter whose sharding ``t`` follows, e.g. for an Adam moment),
    gathered over 'model'; ``t`` itself otherwise. No gradient."""
    rank = current()
    if rank is None or not is_model_sharded(t if like is None else like):
        return t
    return rank.model.all_gather(t, dim=0)
