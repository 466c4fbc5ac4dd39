"""Ranks of a CPU mesh for the port's multi-device tests (gloo, spawned).

``start_world(world, mp, cases)`` starts ``world`` ranks, each capped at
one torch thread, on a ('data', 'model') mesh of ``world // mp`` x ``mp``;
every rank runs every case on its rows, and ``collect`` returns rank 0's
{case name: results}, numpy only. ``run_calls`` runs entry points in turn
in one process of a mesh (``cli/common.py on_mesh`` starts the others, or
each is launched with --distributed). The module imports no JAX, so the
spawned ranks do not either.

A case is a dict: ``kind`` ('train' or 'eval'), ``cfg`` (ModelConfig
fields), ``flat`` (the JAX package's checkpoint leaves, ``params/...`` and
``state/...``), ``batch`` (the global numpy batch), optionally ``fp8``
(``v_features`` as float8 e4m3) and ``masks`` (MAC's dropout masks over the
global batch's rows, as JAX draws them).
"""

from __future__ import annotations

import queue as queue_mod
import time
import numpy as np
import torch
import torch.multiprocessing as tmp

from videonavqa_tpu_torch.cli import common, q_and_v_test, q_only_eval
from videonavqa_tpu_torch.models import ModelConfig, get_model
from videonavqa_tpu_torch.models import mac as mac_mod
from videonavqa_tpu_torch.parallel import collectives, launch, multihost
from videonavqa_tpu_torch.parallel.mesh import make_mesh, param_shardings, put_global
from videonavqa_tpu_torch.train import step as tstep
from videonavqa_tpu_torch.utils.checkpoint import params_from_jax

STEP_OPTIONS = dict(reduction="sum", clip_value=1.0)   # the JAX DP tests' step
LR = 1e-3


def _local_batch(case, rank):
    start, per = multihost.host_batch_slice(len(case["batch"]["label"]), rank)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v[start:start + per]))
             for k, v in case["batch"].items()}
    if case.get("fp8"):
        batch["v_features"] = batch["v_features"].to(torch.float8_e4m3fn)
    return batch


def _whole(tree):
    return {k: collectives.full_leaf(v).detach().numpy().copy()
            for k, v in tstep.tree_items(tree)}


def _placed(case, rank):
    params, state = params_from_jax(case["flat"])
    return put_global(params, param_shardings(params, rank), rank), state


def _train(case, rank):
    """One step of make_train_step on ``rank``'s rows -> the loss, the
    gradient norm, the gradients the step summed over 'data' (before the
    clip) and the ones it applied (after it), and the params and state."""
    cfg = ModelConfig(**case["cfg"])
    spec = get_model(cfg.model)
    params, state = _placed(case, rank)
    train = tstep.make_train_step(spec, cfg, tstep.make_optimizer(params, LR), **STEP_OPTIONS)
    summed, sum_grads = [], collectives.sum_grads_over_data

    def seen(grads):
        summed.append(sum_grads(grads))
        return summed[-1]

    collectives.sum_grads_over_data = seen
    try:
        state, m = train(params, state, _local_batch(case, rank),
                         torch.Generator().manual_seed(5))
    finally:
        collectives.sum_grads_over_data = sum_grads
    assert len(summed) == 1, "the step did not sum its gradients over 'data' once"
    items = tstep.tree_items(params)
    # every rank's replicated leaves after the step: a clip whose norm is not
    # the global one scales them differently on each rank
    replicated = np.concatenate([p.detach().reshape(-1).numpy() for _, p in items
                                 if not collectives.is_model_sharded(p)])
    spread = max(float(np.abs(r - replicated).max())
                 for r in rank.world.all_gather_object(replicated))
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "replica_spread": spread,
            "grads": {k: collectives.full_leaf(g, like=p).numpy().copy()
                      for (k, p), g in zip(items, summed[0])},
            "clipped": {k: collectives.full_leaf(p.grad, like=p).numpy().copy()
                        for k, p in items},
            "params": _whole(params), "state": _whole(state)}


def _eval(case, rank):
    cfg = ModelConfig(**case["cfg"])
    spec = get_model(cfg.model)
    params, state = _placed(case, rank)
    m = tstep.make_eval_step(spec, cfg, reduction="sum")(params, state, _local_batch(case, rank))
    parts = rank.data.all_gather_object((m["preds"].numpy(), m["logits"].numpy()))
    return {"loss": float(m["loss"]), "preds": np.concatenate([p for p, _ in parts]),
            "logits": np.concatenate([lg for _, lg in parts])}


def world_main(r, world, mp, port, inbox, results):
    torch.set_num_threads(1)
    cases = inbox.get()
    multihost.initialize(f"127.0.0.1:{port}", world, r)
    try:
        rank = make_mesh(world, mp).local
        collectives.set_process_rank(rank)
        out = {}
        for case in cases:
            masks = case.get("masks")
            mac_mod.variational_masks = (
                lambda *a, masks=masks: tuple(torch.from_numpy(m) for m in masks))
            out[case["name"]] = (_train if case["kind"] == "train" else _eval)(case, rank)
        if r == 0:
            results.put(out)
    finally:
        collectives.set_process_rank(None)
        multihost.shutdown()


def start_world(world, mp, cases):
    """Start ``cases`` on a ``world``-rank mesh -> a handle for ``collect``.
    The cases go through a queue: a large argument would hold this process
    until each child in turn had imported torch to read it."""
    ctx = tmp.get_context("spawn")
    inbox, results = ctx.Queue(), ctx.Queue()
    procs = launch.spawn_ranks(world_main, (world, mp, launch.free_port(), inbox, results),
                               nprocs=world, first=0, quiet=False)
    inbox.cancel_join_thread()   # a rank that dies unread must not hold this process
    for _ in range(world):
        inbox.put(cases)
    return world, procs, results, inbox   # the queues live until the ranks read them


def collect(handle, timeout=300):
    """{case name: rank 0's results} of a ``start_world``; raises where a
    rank failed, and kills the ranks past ``timeout`` s."""
    world, procs, results, _ = handle
    deadline = time.monotonic() + timeout
    while True:
        try:
            out = results.get(timeout=0.5)
            break
        except queue_mod.Empty:
            if procs.join(timeout=0):   # raises where a rank failed
                raise RuntimeError("the ranks ended without a result")
            if time.monotonic() > deadline:
                launch.kill(procs)
                raise TimeoutError(f"no result from the {world} ranks within {timeout} s")
    launch.join(procs, 60)
    return out


def _numpy(trees):
    return tuple({k: v.detach().cpu().numpy() for k, v in tstep.tree_items(t)} for t in trees)


def _run_training(argv):
    args = common.build_q_and_v_parser().parse_args(argv)
    return _numpy(common.run_training(args, args.model))


ENTRIES = {
    "train": _run_training,
    "q_only": lambda argv: _numpy(q_only_eval.main(argv)),
    "test": q_and_v_test.main,
}


def run_calls(args, calls, out=None):
    """Each (entry, argv) of ``calls`` in turn ('train': run_training ->
    (params, state) as numpy; 'q_only': q_only_eval -> the same; 'test':
    q_and_v_test -> its summary) -> their results. Called by ``on_mesh``
    (``args``: its flags), every rank runs them on its mesh; a process
    launched alone joins each --distributed call's group itself. ``out``:
    an .npz path for the 'train' results' params (a launched process's)."""
    got = []
    with launch.cpu_threads():
        for entry, argv in calls:
            got.append(ENTRIES[entry](argv))
            if torch.distributed.is_initialized():   # rank 0 has written its files
                torch.distributed.barrier()
    if out is not None:
        np.savez(out, **{f"{i}/{k}": v for i, (entry, _) in enumerate(calls)
                         if entry == "train" for k, v in got[i][0].items()})
    return got
