"""Checkpoints in the JAX package's file format, in both directions, with
Adam's state.

A checkpoint is one .npz of '/'-joined pytree paths (``params/...``,
``state/...``, ``opt/...``) plus a JSON ``__meta__`` entry, read and written
with numpy alone, so the JAX package loads a checkpoint the port wrote and
the port loads one the JAX package wrote. Layouts: 2-D conv kernels are HWIO
in the file and OIHW in the port (every 4-D leaf, the calibrated ``int8_wq``
kernels included), 3-D ones DHWIO and OIDHW (every 5-D leaf); Linear and
LSTM weights are ``[out, in]`` on both sides, as are ``int8_scales``. The
serving engine's ``c3d_zero`` state (the C3D's precomputed zero-run, a
function of the weights) is never written, nor read from a file. A list (MAC's twelve ``position_aware`` linears) is
stored under the keys ``0``, ``1``, ... and comes back as a list.

The optimizer is optax's ``inject_hyperparams(adam)`` in the JAX package and
``torch.optim.Adam`` here. Its state maps leaf by leaf: ``count`` is
``step``, ``mu`` is ``exp_avg`` and ``nu`` is ``exp_avg_sq``, with the same
transposes; the hyperparameters (``learning_rate``, ``b1``, ``b2``, ``eps``)
are the param group's ``lr``, ``betas`` and ``eps``. Restoring sets the
learning rate from the checkpoint, as a restored optax state carries its own.

``load_any_checkpoint`` also takes a reference ``torch.save`` checkpoint
(``utils/zoo_import.py``), as the JAX package's does at every
``--checkpoint_path``; ``utils/zoo_export.py`` writes one.

``epoch_path`` names an epoch's file (``e{N}_`` before the basename);
``save_checkpoint_async`` snapshots to the host at once and writes on a
background thread; ``wait_for_pending_saves`` waits for those writes.
``stem_from_jax`` carries the frozen stem's trees (as numpy) across.
"""

from __future__ import annotations

import io
import json
import os
import threading
import zipfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from videonavqa_tpu_torch.train.step import tree_items
from videonavqa_tpu_torch.utils.device import tree_to
from videonavqa_tpu_torch.utils.zoo_import import import_model_checkpoint, verify_shapes

# optax's inject_hyperparams(adam) state, as the JAX package's flatten_tree
# names its leaves
OPT_COUNT = "opt/.count"
OPT_HYPER = "opt/.hyperparams/"
OPT_INNER_COUNT = "opt/.inner_state/0/.count"
OPT_MU = "opt/.inner_state/0/.mu/"
OPT_NU = "opt/.inner_state/0/.nu/"


def read_npz(path):
    """(flat {path: array}, meta dict) of a checkpoint."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    meta_raw = flat.pop("__meta__", None)
    meta = json.loads(bytes(meta_raw.tobytes()).decode("utf-8")) if meta_raw is not None else {}
    return flat, meta


# state entries that are derived from the weights, never stored
UNSTORED_STATE = ("c3d_zero",)

# the file's conv layouts (HWIO, DHWIO) -> the port's (OIHW, OIDHW), by rank
_TO_PORT = {4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}
_TO_FILE = {4: (2, 3, 1, 0), 5: (2, 3, 4, 1, 0)}


def _to_torch(a: np.ndarray) -> torch.Tensor:
    if a.ndim in _TO_PORT:
        a = a.transpose(_TO_PORT[a.ndim])
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` in the file's layout (OIHW -> HWIO, OIDHW -> DHWIO)."""
    a = t.detach().to("cpu", copy=True).numpy()
    return np.ascontiguousarray(a.transpose(_TO_FILE[a.ndim])) if a.ndim in _TO_FILE else a


def _stored_items(state):
    """tree_items of a state without its UNSTORED_STATE entries."""
    return tree_items({k: v for k, v in state.items() if k not in UNSTORED_STATE})


def _nest(flat, prefix):
    tree = {}
    for key, a in flat.items():
        if not key.startswith(prefix):
            continue
        *parents, leaf = key[len(prefix):].split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = _to_torch(a)
    return _lists(tree)


def _lists(node):
    """Dicts keyed '0'..'n-1' (a saved list) become lists, at any depth."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node) and \
            sorted(int(k) for k in node) == list(range(len(node))):
        return [node[str(i)] for i in range(len(node))]
    return node


def params_from_jax(flat: dict[str, np.ndarray]):
    """(params, state) as nested dicts of CPU tensors in the port's layouts."""
    return _nest(flat, "params/"), _nest(flat, "state/")


def load_jax_checkpoint(path, device):
    """(params, state, meta) of a checkpoint, as new tensors on ``device``."""
    flat, meta = read_npz(path)
    params, state = params_from_jax(flat)
    return tree_to(params, device), tree_to(state, device), meta


def _tree_to_torch(node):
    if isinstance(node, dict):
        return {k: _tree_to_torch(v) for k, v in node.items()}
    return _to_torch(np.asarray(node))


def stem_from_jax(vgg_np, det_params_np, det_state_np, device):
    """(vgg_params, det_params, det_state) on ``device`` from the JAX stem's
    trees as numpy: ``init_vgg_partial`` and ``init_obj_detector`` (or the
    weights that ``load_stem`` imports). HWIO conv kernels become OIHW."""
    return tuple(tree_to(_tree_to_torch(t), device)
                 for t in (vgg_np, det_params_np, det_state_np))


def qstem_from_jax(qstem_np, device):
    """The port's int8 stem (``stem/quant.py quantize_stem``'s tree) on
    ``device`` from the tree JAX's ``quantize_stem`` returns, as numpy: the
    HWIO int8 kernels become OIHW; ``sw``, ``bias`` and the activation
    quantizer's ``m`` (a scalar, or per input channel where equalized) and
    ``s`` pass as f32, a Python float as the f32 JAX computes with."""
    def layer(lay):
        out = {"wq": _to_torch(np.asarray(lay["wq"])).contiguous(),
               "sw": torch.tensor(np.asarray(lay["sw"], np.float32)),
               "bias": torch.tensor(np.asarray(lay["bias"], np.float32))}
        if lay.get("aq") is not None:
            out["aq"] = {k: torch.tensor(np.asarray(lay["aq"][k], np.float32))
                         for k in ("m", "s")}
        return tree_to(out, device)

    scales = qstem_np.get("act_scales")
    return {"vgg": {k: layer(v) for k, v in qstem_np["vgg"].items()},
            "det": {k: layer(v) for k, v in qstem_np["det"].items()},
            "act_scales": None if scales is None else {k: float(v) for k, v in scales.items()}}


# --- Adam's state ----------------------------------------------------------

def _adam_group(optimizer):
    if not isinstance(optimizer, torch.optim.Adam) or len(optimizer.param_groups) != 1:
        raise ValueError("the checkpoint's optimizer state is one torch.optim.Adam group")
    return optimizer.param_groups[0]


def adam_to_flat(optimizer, params):
    """``optimizer``'s state over ``params`` as optax's flat ``opt/...``
    leaves. A parameter not stepped yet has zero moments; every stepped one
    must share one step count."""
    group = _adam_group(optimizer)
    steps = {float(optimizer.state[p]["step"]) for _, p in tree_items(params)
             if p in optimizer.state}
    if len(steps) > 1:
        raise ValueError(f"Adam's parameters were stepped unequally: {sorted(steps)}")
    count = np.int32(steps.pop() if steps else 0)
    b1, b2 = group["betas"]
    flat = {OPT_COUNT: count, OPT_INNER_COUNT: count}
    for name, value in (("b1", b1), ("b2", b2), ("eps", group["eps"]), ("eps_root", 0.0),
                        ("learning_rate", group["lr"])):
        flat[OPT_HYPER + name] = np.float32(value)
    for path, p in tree_items(params):
        st = optimizer.state.get(p)
        for prefix, key in ((OPT_MU, "exp_avg"), (OPT_NU, "exp_avg_sq")):
            flat[prefix + path] = _to_numpy(st[key] if st else torch.zeros_like(p))
    return flat


def _leaf(flat, key, like):
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf {key!r}")
    t = _to_torch(flat[key])
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf {key!r} has shape {tuple(t.shape)}, "
                         f"expected {tuple(like.shape)}")
    return t.to(device=like.device, dtype=like.dtype)


def _stored(current, stored):
    """The file keeps a hyperparameter in f32: ``current`` where it rounds to
    the stored value, else the stored value."""
    return current if float(np.float32(current)) == stored else stored


def adam_from_flat(optimizer, params, flat):
    """Set ``optimizer``'s moments, step and hyperparameters (the learning
    rate included) from optax's flat ``opt/...`` leaves."""
    group = _adam_group(optimizer)
    hyper = {name: float(flat[OPT_HYPER + name])
             for name in ("learning_rate", "b1", "b2", "eps", "eps_root")}
    if hyper["eps_root"] != 0.0:
        raise ValueError("torch.optim.Adam has no eps_root; the checkpoint's is "
                         f"{hyper['eps_root']}")
    group["lr"] = _stored(group["lr"], hyper["learning_rate"])
    group["betas"] = tuple(_stored(b, hyper[k]) for b, k in zip(group["betas"], ("b1", "b2")))
    group["eps"] = _stored(group["eps"], hyper["eps"])
    count = int(flat[OPT_INNER_COUNT])
    for path, p in tree_items(params):
        optimizer.state[p] = {"step": torch.tensor(float(count), dtype=torch.float32),
                              "exp_avg": _leaf(flat, OPT_MU + path, p),
                              "exp_avg_sq": _leaf(flat, OPT_NU + path, p)}


# --- save and load ---------------------------------------------------------

def _gather_flat(params, state, optimizer, meta):
    """A host snapshot of every leaf in the file's layout."""
    flat = {"params/" + k: _to_numpy(v) for k, v in tree_items(params)}
    if state is not None:
        flat.update({"state/" + k: _to_numpy(v) for k, v in _stored_items(state)})
    if optimizer is not None:
        flat.update(adam_to_flat(optimizer, params))
    flat["__meta__"] = np.frombuffer(json.dumps(meta or {}).encode("utf-8"), dtype=np.uint8)
    return flat


def _write_flat(path, flat):
    buf = io.BytesIO()
    np.savez(buf, **flat)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)  # atomic against a failure mid-write


def save_checkpoint(path, *, params, state=None, optimizer=None, meta=None):
    """Write ``params`` (and ``state``, and ``optimizer``'s Adam state) to
    ``path`` in the JAX package's format."""
    _write_flat(path, _gather_flat(params, state, optimizer, meta))


def _is_torch_save(path: str) -> bool:
    """True for a file ``torch.save`` wrote: a zip with a ``data.pkl`` member
    (the npz checkpoints are zips too, but carry ``__meta__.npy``), or a bare
    pickle of an older torch."""
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as z:
            names = z.namelist()
        if any(n.split("/")[-1] == "__meta__.npy" for n in names):
            return False
        return any(n.endswith("data.pkl") for n in names)
    with open(path, "rb") as f:
        return f.read(1) == b"\x80"


def load_checkpoint(path, *, params, state=None, optimizer=None):
    """Copy a checkpoint in the JAX package's format into the live tensors,
    in place -> its meta dict.

    ``params`` (and ``state``) are the templates, as in the JAX package: each
    leaf must be in the file with the same shape; ``state`` is left as it is
    where the file has none, and so is ``optimizer`` where it has no
    ``opt/`` leaves."""
    flat, meta = read_npz(path)
    with torch.no_grad():
        for prefix, tree in (("params/", params), ("state/", state)):
            if tree is None or (prefix == "state/" and
                                not any(k.startswith(prefix) for k in flat)):
                continue
            items = tree_items(tree) if prefix == "params/" else _stored_items(tree)
            for k, t in items:
                t.copy_(_leaf(flat, prefix + k, t))
    if optimizer is not None and any(k.startswith("opt/") for k in flat):
        adam_from_flat(optimizer, params, flat)
    return meta


def load_any_checkpoint(path, *, model_name, cfg, params, state=None, optimizer=None):
    """``load_checkpoint`` that also takes the reference's ``torch.save``
    checkpoints (``{'epoch', 'state_dict', 'optimizer', ...}``, or a bare
    state_dict), so ``--checkpoint_path`` can point at a reference ``.pt``
    for eval, test, serving and resume -> the meta dict (``epoch`` where the
    file has one).

    A reference file goes through ``zoo_import.import_model_checkpoint``:
    its leaves must have the templates' paths and shapes, and are copied into
    them in place; the leaves reference files lack are drawn from seed 0 and
    named in a printed line. Its optimizer moments are not imported:
    ``optimizer`` is left as it is, so a resumed run starts Adam afresh at
    the epoch after the file's, as in the JAX package."""
    if not _is_torch_save(path):
        return load_checkpoint(path, params=params, state=state, optimizer=optimizer)
    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj["state_dict"] if isinstance(obj, dict) and "state_dict" in obj else obj
    got_params, got_state, missing = import_model_checkpoint(model_name, sd, cfg)
    live = [(params, got_params)]
    if state is not None:
        state = {k: v for k, v in state.items() if k not in UNSTORED_STATE}
        live.append((state, got_state))
    verify_shapes(model_name, got_params, got_state,
                  (params, got_state if state is None else state))
    with torch.no_grad():
        for tree, got in live:
            got = dict(tree_items(got))
            for k, t in tree_items(tree):
                t.copy_(got[k].to(device=t.device, dtype=t.dtype))
    if missing:
        print(f"=> Imported reference torch checkpoint {path}; "
              f"{len(missing)} leaves absent from reference state_dicts "
              f"re-initialized seeded (reference quirk): {missing}")
    meta = {}
    if isinstance(obj, dict) and "epoch" in obj:
        meta["epoch"] = int(obj["epoch"])
    return meta


def epoch_path(checkpoint_path: str, epoch: int) -> str:
    """'e{N}_' before the basename."""
    d, b = os.path.split(checkpoint_path)
    return os.path.join(d, f"e{epoch}_{b}")


_pending = []
_pending_lock = threading.Lock()
_executor = None


def save_checkpoint_async(path, *, params, state=None, optimizer=None, meta=None):
    """Snapshot every leaf to the host now (later steps update the tensors in
    place), then serialize and write on a background thread. -> the future."""
    global _executor
    flat = _gather_flat(params, state, optimizer, meta)
    with _pending_lock:
        if _executor is None:
            _executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt")
        fut = _executor.submit(_write_flat, path, flat)
        _pending.append(fut)
    return fut


def wait_for_pending_saves():
    """Wait until every queued save is on disk; raises the first failure."""
    with _pending_lock:
        pending = list(_pending)
        _pending.clear()
    for fut in pending:
        fut.result()
