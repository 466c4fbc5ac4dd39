"""The port's mesh (videonavqa_tpu_torch/parallel/) against the JAX package's
single-device numbers, on the CPU (the counterpart of tests/test_parallel.py).

The port's ranks are processes on gloo (tests/_torch_mesh_ranks.py): one
world of 2 (data 2) runs every data-parallel case, one world of 4 (data 2 x
model 2) the model-parallel ones; both start once for the file and run
while this process computes the JAX side: its jitted single-device steps
on the same weights (the port's seeded init, in both), the same numpy batch and the
same rng (MAC's dropout masks:
the ones JAX draws from that rng, over the global batch's rows, handed to
the ranks). Every gradient is the one make_train_step produced: the sum
over 'data' it made before the clip, and the clipped one it applied.
Bounds are JAX's own DP test's: the loss rtol 1e-5; both gradients atol
1e-4 / rtol 1e-3 (against JAX's raw gradients and its clip_grads of them);
the params after one Adam step atol 2.5e-3 (Adam's first step turns float
noise on near-zero gradients into steps of ~lr); the BN state 1e-5; the eval
step's loss rtol 1e-5 and its predictions equal. Tighter than JAX's: the
gradient norm after the clip rtol 1e-4, and the params 1e-5 where the
clipped gradient exceeds 1e-6, so that a step left out or wrongly scaled
fails (the clip engages in every case: JAX's raw norms are 7.5 to 86); and
every rank's replicated params equal to the bit after the step.
"""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import _torch_mesh_ranks as ranks
from videonavqa_tpu.models import ModelConfig as JaxConfig
from videonavqa_tpu.models import get_model as jax_get_model
from videonavqa_tpu.parallel import make_mesh as jax_make_mesh
from videonavqa_tpu.parallel import param_shardings as jax_param_shardings
from videonavqa_tpu.train import loss as jloss
from videonavqa_tpu.train import step as jstep
from videonavqa_tpu.utils import checkpoint as jckpt
from videonavqa_tpu_torch.cli.common import host_localize_batch
from videonavqa_tpu_torch.models import ModelConfig, get_model
from videonavqa_tpu_torch.parallel import make_mesh, multihost, param_shardings
from videonavqa_tpu_torch.train.step import tree_items
from videonavqa_tpu_torch.utils import checkpoint as tckpt

LOSS_RTOL = 1e-5
GRAD_TOL = dict(atol=1e-4, rtol=1e-3)
NORM_RTOL = 1e-4
PARAM_ATOL = 2.5e-3
# Adam's first step is lr * g / (|g| + 1e-8): lr * sign(g) wherever the
# clipped gradient clears float noise, and there the params must agree far
# inside lr (a leaf left out, or a step of the wrong sign, is off by ~lr)
GRAD_CLEAR = 1e-6
CLEAR_PARAM_ATOL = 1e-5
STATE_ATOL = 1e-5

BASE = dict(num_res_blocks=1, num_res_block_channels=16, num_input_channels=8,
            num_tail_channels=4, max_num_frames=3, compute_dtype="float32", num_classes=8,
            vocab_size=17, embed_size=8, hidden_size=8)
CFGS = {
    "film_gp_pt": dict(BASE, model="film_gp_pt"),
    "film_attn_pt": dict(BASE, model="film_attn_pt", at_hidden_size=8),
    "mac": dict(BASE, model="mac", mac_dim=16, mac_max_step=3),
    "time_multi_hop": dict(BASE, model="time_multi_hop"),
}
B, T = 16, 3


def _batch(seed, ragged, B=B):
    r = np.random.default_rng(seed)
    v_len = r.integers(1, T + 1, B) if ragged else np.full(B, T)
    q_len = r.integers(1, 7, B) if ragged else np.full(B, 4)
    return {"v_features": r.standard_normal((B, T, 10, 13, 8)).astype(np.float32),
            "question": r.integers(0, 17, (B, 7)).astype(np.int32),
            "v_len": v_len.astype(np.int32), "q_len": q_len.astype(np.int32),
            "label": r.integers(0, 8, B).astype(np.int32)}


@functools.lru_cache(maxsize=None)
def _weights(model):
    """The port's seeded init as the JAX package's checkpoint leaves, and as
    JAX trees (shaped by JAX's init, traced, not run)."""
    jcfg = JaxConfig(**CFGS[model])
    params, state = get_model(model).init(torch.Generator().manual_seed(0),
                                          ModelConfig(**CFGS[model]), torch.device("cpu"))
    flat = {k: v for k, v in tckpt._gather_flat(params, state, None, {}).items()
            if k != "__meta__"}
    jp0, js0 = jax.eval_shape(functools.partial(jax_get_model(model).init, cfg=jcfg),
                              jax.random.PRNGKey(0))
    return flat, jckpt.unflatten_like(jp0, flat, "params/"), \
        jckpt.unflatten_like(js0, flat, "state/")


def _init(cfg):
    flat, jp, js = _weights(cfg["model"])
    return JaxConfig(**cfg), jp, js, flat


def _masks(cfg, rng, rows):
    """MAC's (control, memory) masks as the JAX model draws them from ``rng``."""
    keep = 1.0 - JaxConfig(**cfg).mac_dropout
    return [np.asarray(jax.random.bernoulli(k, keep, (rows, cfg["mac_dim"]))
                       .astype(jnp.float32) / keep) for k in jax.random.split(rng)]


RNG = jax.random.PRNGKey(5)
# (case name, model, kind, batch seed, ragged, extra config, fp8)
DP_CASES = [("train_film_gp_pt", "film_gp_pt", "train", 3, False, {}, False),
            ("train_film_attn_pt", "film_attn_pt", "train", 3, True, {}, False),
            ("train_mac", "mac", "train", 3, False, {}, False),
            ("train_fp8", "film_gp_pt", "train", 9, False, {}, True),
            ("eval_f32", "film_attn_pt", "eval", 11, True, {}, False),
            ("eval_int8", "film_gp_pt", "eval", 21, True, {"use_int8_trunk": True}, False)]
# the DP cases' weights and batches again: the same JAX numbers hold them
MP_CASES = [("mp_film_attn_pt", "film_attn_pt", "train", 3, True, {}, False),
            ("mp_mac", "mac", "train", 3, False, {}, False)]


def _case_batch(seed, ragged, fp8):
    batch = _batch(seed, ragged)
    if fp8:   # values an e4m3 holds exactly
        batch["v_features"] = batch["v_features"].astype(ml_dtypes.float8_e4m3fn) \
            .astype(np.float32)
    return batch


def _case(name, model, kind, seed, ragged, extra, fp8):
    cfg = dict(CFGS[model], **extra)
    jcfg, jp, js, flat = _init(cfg)
    case = {"name": name, "kind": kind, "cfg": cfg, "flat": flat, "seed": seed,
            "ragged": ragged, "fp8": fp8, "batch": _case_batch(seed, ragged, fp8)}
    if model == "mac":
        case["masks"] = _masks(cfg, RNG, B * T)
    return case, (jcfg, jp, js)


class _Worlds:
    """The two worlds, started at once; a case's results are collected when
    a test first asks for them, after it has computed JAX's side (``cases``:
    {name: ((JAX config, params, state), case)})."""

    def __init__(self):
        self.cases, self.handles, self.got = {}, [], {}
        for world, mp, specs in ((2, 1, DP_CASES), (4, 2, MP_CASES)):
            built = [_case(*s) for s in specs]
            self.handles.append((ranks.start_world(world, mp, [c for c, _ in built]),
                                 [c["name"] for c, _ in built]))
            self.cases.update({c["name"]: (j, c) for c, j in built})

    def __getitem__(self, name):
        for handle, names in self.handles:
            if name in names and name not in self.got:
                self.got.update(ranks.collect(handle))
        return (self.got[name], *self.cases[name])


@pytest.fixture(scope="module")
def worlds():
    """[case name] -> (port results, (JAX config, params, state), case)."""
    return _Worlds()


def _as_jax(name, a):
    """A port leaf (OIHW) in the JAX layout (HWIO)."""
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a


def _jax_batch(case):
    b = dict(case["batch"])
    if case["fp8"]:
        b["v_features"] = b["v_features"].astype(ml_dtypes.float8_e4m3fn)
    return {k: jnp.asarray(v) for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def _jax_train(model, seed, ragged, fp8, grads):
    """JAX's single-device step (sum loss, clip 1.0, Adam 1e-3) -> (loss,
    gradient norm, params, state, and with ``grads`` the raw gradients and
    the clipped ones, else None)."""
    jcfg = JaxConfig(**CFGS[model])
    _, jp, js = _weights(model)
    spec = jax_get_model(model)
    opt = jstep.make_optimizer(1e-3)
    step = jstep.make_train_step(spec, jcfg, opt, reduction="sum", clip_value=1.0,
                                 donate=False)
    batch = _jax_batch({"batch": _case_batch(seed, ragged, fp8), "fp8": fp8})

    def loss_fn(p, b):
        logits, _ = spec.apply(p, js, b, jcfg, train=True, rng=RNG)
        return jloss.cross_entropy_loss(logits, b["label"], reduction="sum")

    def step_and_grads(p, o, b):   # one compile for both
        return step(p, js, o, b, RNG), jax.grad(loss_fn)(p, b) if grads else None

    (p1, s1, _, m1), g = jax.jit(step_and_grads)(jp, opt.init(jp), batch)
    raw = clipped = None
    if grads:
        raw = dict(tree_items(g))
        clipped = dict(tree_items(jstep.clip_grads(g, clip_value=1.0)))
    return float(m1["loss"]), float(m1["grad_norm"]), dict(tree_items(p1)), \
        dict(tree_items(s1)), raw, clipped


def _check_grads(got, want, name):
    assert sorted(want) == sorted(got)
    for k, g in got.items():
        np.testing.assert_allclose(_as_jax(k, g), np.asarray(want[k]), err_msg=f"{name} {k}",
                                   **GRAD_TOL)


def _check_train(worlds, name, grads=True):
    """The port's step against JAX's: the loss, the gradient norm after the
    clip, the params and the BN state; with ``grads`` also the gradients
    the step summed over 'data' (JAX's raw gradients) and the ones it
    applied (JAX's after clip_grads)."""
    _, case = worlds.cases[name]
    cfg = case["cfg"]
    loss, norm, want_p, want_s, want_g, want_c = _jax_train(
        cfg["model"], case["seed"], case["ragged"], case["fp8"], grads)
    got = worlds[name][0]
    np.testing.assert_allclose(got["loss"], loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"], norm, rtol=NORM_RTOL)
    assert got["replica_spread"] == 0.0, "the ranks' replicated params differ"
    if grads:
        _check_grads(got["grads"], want_g, "summed")
        _check_grads(got["clipped"], want_c, "clipped")
    for k, v in got["params"].items():
        v, want = _as_jax(k, v), np.asarray(want_p[k])
        np.testing.assert_allclose(v, want, atol=PARAM_ATOL, err_msg=k)
        if grads:   # where the gradient stands clear of float noise
            clear = np.abs(np.asarray(want_c[k])) > GRAD_CLEAR
            np.testing.assert_allclose(v[clear], want[clear], atol=CLEAR_PARAM_ATOL,
                                       err_msg=k)
    for k, v in got["state"].items():
        np.testing.assert_allclose(v, np.asarray(want_s[k]), atol=STATE_ATOL, err_msg=k)


@pytest.mark.parametrize("name", ["train_film_gp_pt", "train_film_attn_pt", "train_mac"])
def test_dp_matches_single_device(worlds, name):
    """DP 2 (8 rows a rank): film_gp_pt; film_attn_pt with ragged v_len (the
    attention mask's batch max and the frame BN's counts over the global
    batch); MAC with its dropout masks drawn over the global batch's rows."""
    _check_train(worlds, name)


def test_dp_fp8_feature_batch_matches_single_device(worlds):
    """fp8 e4m3 cached features, widened in the step: the loss, the params
    and the BN state (as the JAX test holds them)."""
    _check_train(worlds, "train_fp8", grads=False)


@pytest.mark.parametrize("name", ["eval_f32", "eval_int8"])
def test_eval_step_dp_matches_single_device(worlds, name):
    """make_eval_step under DP 2 with ragged lengths, f32 and with the
    dynamic int8 trunk (its activation absmax over the global batch)."""
    (jcfg, jp, js), case = worlds.cases[name]
    m = jstep.make_eval_step(jax_get_model(jcfg.model), jcfg, reduction="sum")(
        jp, js, _jax_batch(case), jax.random.PRNGKey(13))
    got = worlds[name][0]
    np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_array_equal(got["preds"], np.asarray(m["preds"]))


@pytest.mark.parametrize("name", ["mp_film_attn_pt", "mp_mac"])
def test_data_and_model_parallel_matches_single_device(worlds, name):
    """data 2 x model 2: film_attn_pt's decoder and out_linear, MAC's read
    and write units and out classifier rows split over 'model'; the
    gathered gradients of the sharded leaves, the step and the BN state."""
    _check_train(worlds, name)


@pytest.mark.parametrize("model", ["film_gp_pt", "film_attn_pt", "mac", "time_multi_hop"])
def test_param_shardings_mark_jax_s_paths(model):
    flat, jp, _ = _weights(model)
    want = {k for k, s in tree_items(jax_param_shardings(jp, jax_make_mesh(8, 2)))
            if len(s.spec) and s.spec[0] == "model"}
    params, _ = tckpt.params_from_jax(flat)
    got = {k for k, s in tree_items(param_shardings(params, make_mesh(8, 2, ["cpu"] * 8)))
           if s == ("model", None)}
    assert got == want and got


def _rank(d, dp):
    return SimpleNamespace(shape={"data": dp, "model": 1}, data_index=d)


def test_host_batch_slice_math():
    assert [multihost.host_batch_slice(32, _rank(d, 4)) for d in range(4)] == \
        [(0, 8), (8, 8), (16, 8), (24, 8)]
    assert multihost.host_batch_slice(32, None) == (0, 32)
    with pytest.raises(AssertionError):
        multihost.host_batch_slice(30, _rank(0, 4))


def test_host_localize_batch_math():
    nb = {"label": np.arange(8, dtype=np.int32), "question": np.arange(24).reshape(8, 3),
          "num_valid": np.int32(5), "scalar_meta": np.float32(1.5)}
    out = [host_localize_batch(dict(nb), 8, _rank(d, 2)) for d in range(2)]
    np.testing.assert_array_equal(out[0]["label"], [0, 1, 2, 3])
    np.testing.assert_array_equal(out[1]["label"], [4, 5, 6, 7])
    np.testing.assert_array_equal(np.concatenate([o["question"] for o in out]),
                                  nb["question"])
    assert int(out[0]["num_valid"]) == 4 and int(out[1]["num_valid"]) == 1
    assert all(o["scalar_meta"] == np.float32(1.5) for o in out)


def test_global_batch_from_host_shards_single_process():
    mesh = make_mesh(2, 1, ["cpu"] * 2)
    host = {"x": np.arange(8, dtype=np.float32).reshape(4, 2), "y": np.arange(4)}
    for r in mesh.ranks:
        out = multihost.global_batch_from_host_shards(r, host)
        for k, v in host.items():
            assert out[k].device == r.device
            np.testing.assert_array_equal(out[k].numpy(), v)


def test_make_mesh_raises_on_insufficient_devices():
    with pytest.raises(ValueError, match="only"):
        make_mesh(1024)
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(3, 2, ["cpu"] * 3)
    assert make_mesh(4, 2, [torch.device("cpu")] * 4).shape == {"data": 2, "model": 2}
