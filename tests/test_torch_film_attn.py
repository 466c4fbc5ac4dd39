"""film_attn_pt (eval) in the PyTorch port against the JAX package, on the CPU.

The same numpy-seeded inputs and the JAX weights, bridged into the port, go
through both. The JAX side reaches its Pallas kernels in interpret mode where
its config asks for them. f32 logits agree to atol 1e-5. The calibrated int8
trunk is held to ``int8_scales`` at rtol 1e-5 (int8 weights bitwise, their
scales to one ulp), and to logits at atol 2e-3 with equal argmax: the two
calibrations' f32 absmax can differ in the last bit, and one activation
landing on the other side of a rounding boundary moves one int8 step, which
the dequantized output carries.

In bf16, the served dtype, the JAX side runs op by op (each op rounds to bf16
where its code says; inside one jitted graph XLA's simplifier may drop bf16
round trips). The trunk's bf16 output lies within BF16_ULPS bf16 ulps of the
largest output with at least BF16_EQUAL_SHARE of it bit-equal (measured: at
most 0.5 ulps, 99.97-100% equal over three seeds); casting the FiLM affine in
f32 instead of the conv output's dtype leaves 34-42% equal and 1.3-1.7 ulps.
The logits (f32 after the bf16 trunk) agree to BF16_LOGIT_ATOL (measured at
most 1.6e-7; with the affine in f32, 3.4e-4 to 6.5e-4).
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videonavqa_tpu.models import ModelConfig as JaxConfig
from videonavqa_tpu.models import get_model as jax_get_model
from videonavqa_tpu.models.film import film_trunk as jax_film_trunk
from videonavqa_tpu.train.step import _forward as jax_forward
from videonavqa_tpu.utils.checkpoint import flatten_tree
from videonavqa_tpu_torch.models import ModelConfig, get_model
from videonavqa_tpu_torch.models import film as film_mod
from videonavqa_tpu_torch.train.step import make_eval_step
from videonavqa_tpu_torch.utils.checkpoint import params_from_jax

SMALL = dict(num_classes=7, vocab_size=19, embed_size=8, hidden_size=8, at_hidden_size=8,
             num_res_blocks=2, num_res_block_channels=16, num_input_channels=12,
             num_tail_channels=4, max_num_frames=6, max_q_len=9, compute_dtype="float32")
INT8_LOGIT_ATOL = 2e-3
BF16_ULPS = 1
BF16_EQUAL_SHARE = 0.99
BF16_LOGIT_ATOL = 1e-5


# The JAX side runs jitted (one compile per config and shape, much cheaper on
# the CPU than op-by-op dispatch), and what several tests share is computed
# once per process and only read.

@functools.lru_cache(maxsize=None)
def _jax_apply(jcfg):
    """jitted (params, state, batch) -> (logits, new_state) of the JAX model."""
    spec = jax_get_model("film_attn_pt")
    return jax.jit(lambda p, s, b: spec.apply(p, s, b, jcfg, train=False,
                                              rng=jax.random.PRNGKey(1)))


def _setup(**extra):
    return _setup_cached(tuple(sorted(extra.items())))


@functools.lru_cache(maxsize=None)
def _setup_cached(extra_items):
    extra = dict(extra_items)
    jcfg = JaxConfig(**{**SMALL, **extra})
    jspec = jax_get_model("film_attn_pt")
    jp, js = jax.jit(jspec.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    flat = flatten_tree(jp, "params/")
    flat.update(flatten_tree(js, "state/"))
    params, state = params_from_jax(flat)
    return jcfg, jspec, jp, js, ModelConfig(**{**SMALL, **extra}), params, state


def _batch(T, seed=0, B=3):
    r = np.random.default_rng(seed)
    feats = np.maximum(r.standard_normal((B, T, 10, 13, 12)), 0).astype(np.float32)
    q = r.integers(1, 19, (B, 9)).astype(np.int32)
    v_len = np.array([T, 2, 3][:B], np.int32)
    q_len = np.array([9, 4, 6][:B], np.int32)
    return {"v_features": feats, "question": q, "v_len": v_len, "q_len": q_len}


def _jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _interpret_pallas(monkeypatch):
    """Route the JAX package's Pallas kernels through interpret mode."""
    for mod_name, name in (("attn_tail_pallas", "attn_tail_pallas"),
                           ("film_reencode_pallas", "film_reencode_pallas"),
                           ("int8_matmul_pallas", "matmul_int8_fused_pallas")):
        mod = importlib.import_module(f"videonavqa_tpu.kernels.{mod_name}")
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name), interpret=True))


@functools.lru_cache(maxsize=None)
def _jax_logits(T):
    jcfg, _, jp, js, _, _, _ = _setup()
    return np.asarray(_jax_apply(jcfg)(jp, js, _jax(_batch(T)))[0])


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("T", [6, 4])  # 6: full frame axis; 4: bucket-trimmed
def test_film_attn_logits_match_jax(T, kernels):
    _, _, _, _, cfg, params, state = _setup()
    b = _batch(T)
    want = _jax_logits(T)
    cfg = dataclasses.replace(cfg, use_pallas_kernels=kernels)
    got, _ = get_model("film_attn_pt").apply(params, state, _torch(b), cfg)
    assert got.shape == (3, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@functools.lru_cache(maxsize=None)
def _calibrate_both(T=4):
    jcfg, jspec, jp, js, cfg, params, state = _setup(use_int8_trunk=True)
    b = _batch(T)
    jcal = dataclasses.replace(jcfg, int8_trunk_calibrate=True)
    want, jstate = _jax_apply(jcal)(jp, js, _jax(b))
    tcal = dataclasses.replace(cfg, int8_trunk_calibrate=True)
    got, tstate = get_model("film_attn_pt").apply(params, state, _torch(b), tcal)
    return jcfg, jspec, jp, jstate, cfg, params, tstate, b, want, got


def test_int8_calibration_matches_jax():
    _, _, _, jstate, _, _, tstate, _, want, got = _calibrate_both()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    jscales, tscales = jstate["trunk"]["int8_scales"], tstate["trunk"]["int8_scales"]
    assert sorted(jscales) == sorted(tscales) == sorted(
        ["conv_init", "conv1x1_0", "conv3x3_0", "conv1x1_1", "conv3x3_1"])
    for name in jscales:
        np.testing.assert_allclose(float(tscales[name]), float(jscales[name]), rtol=1e-5)
        jwq = np.asarray(jstate["trunk"]["int8_wq"][name]["wq"]).transpose(3, 2, 0, 1)
        np.testing.assert_array_equal(tstate["trunk"]["int8_wq"][name]["wq"].numpy(), jwq)
        # under jit XLA may divide by 127 as a multiply by its reciprocal: one ulp
        np.testing.assert_allclose(tstate["trunk"]["int8_wq"][name]["scale"].numpy(),
                                   np.asarray(jstate["trunk"]["int8_wq"][name]["scale"]),
                                   rtol=1e-6)


@pytest.mark.parametrize("fused", [True, False])
def test_int8_logits_match_jax(fused, monkeypatch):
    """Static int8 serving, with the fused 1x1 kernel (rows 3*4*130 = 1560 are
    under the gate) and without it."""
    jcfg, jspec, jp, jstate, cfg, params, tstate, _, _, _ = _calibrate_both()
    b = _batch(4, seed=1)
    if fused:
        _interpret_pallas(monkeypatch)
    jcfg = dataclasses.replace(jcfg, use_pallas_kernels=fused)
    cfg = dataclasses.replace(cfg, use_pallas_kernels=fused)
    calls = []
    spy = film_mod.matmul_int8_fused
    monkeypatch.setattr(film_mod, "matmul_int8_fused",
                        lambda *a, **k: calls.append(1) or spy(*a, **k))
    want, _ = _jax_apply(jcfg)(jp, jstate, _jax(b))
    got, _ = get_model("film_attn_pt").apply(params, tstate, _torch(b), cfg)
    assert len(calls) == (2 if fused else 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=INT8_LOGIT_ATOL)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), np.asarray(want).argmax(-1))


def test_int8_fused_row_gate(monkeypatch):
    """Above INT8_FUSED_MAX_ROWS the 1x1 convs leave the fused kernel."""
    _, _, _, _, cfg, params, tstate, _, _, _ = _calibrate_both()
    cfg = dataclasses.replace(cfg, use_pallas_kernels=True)
    calls = []
    spy = film_mod.matmul_int8_fused
    monkeypatch.setattr(film_mod, "matmul_int8_fused",
                        lambda *a, **k: calls.append(1) or spy(*a, **k))
    monkeypatch.setattr(film_mod, "INT8_FUSED_MAX_ROWS", 3 * 4 * 130 - 1)
    get_model("film_attn_pt").apply(params, tstate, _torch(_batch(4)), cfg)
    assert not calls
    monkeypatch.setattr(film_mod, "INT8_FUSED_MAX_ROWS", 3 * 4 * 130)
    get_model("film_attn_pt").apply(params, tstate, _torch(_batch(4)), cfg)
    assert len(calls) == 2


def test_int8_fused_row_gate_value():
    """The port's gate comes from its own measurement on the H100
    (chip_smoke.py sweep_int8_gate): the fused kernel was the faster route at
    every count swept, up to 256 x 35 frames x 10 x 13 folded rows, so every
    served batch (at most 32 x 35) takes it. The JAX package keeps the 9,100
    it measured on a TPU."""
    assert film_mod.INT8_FUSED_MAX_ROWS == 256 * 35 * 130
    jax_film = importlib.import_module("videonavqa_tpu.models.film")
    assert jax_film.INT8_FUSED_MAX_ROWS == 9100


@pytest.mark.parametrize("channels", [1088, 2048, 4096])
def test_int8_trunk_wider_than_the_fused_kernel_is_refused_at_set_up(channels):
    """Off the CPU a trunk whose 1x1 conv the kernel does not take (K over
    1024, or not a multiple of 128) is refused when the trunk is set up, not
    at its first launch; on the CPU the plain version takes any width."""
    cfg = ModelConfig(model="film_attn_pt", num_res_block_channels=channels,
                      use_int8_trunk=True, use_pallas_kernels=True)
    state = {"int8_scales": {}, "int8_wq": {}}
    with pytest.raises(ValueError, match="K <= 1024"):
        film_mod._trunk_convs({}, state, cfg, 4550, {}, torch.device("meta"))
    _, block_convs = film_mod._trunk_convs({}, state, cfg, 4550, {}, torch.device("cpu"))
    assert block_convs is not None


def test_eval_step_widens_fp8_features():
    jcfg, jspec, jp, js, cfg, params, state = _setup()
    b = _batch(5)
    jb = dict(_jax(b), v_features=jnp.asarray(b["v_features"]).astype(jnp.float8_e4m3fn))
    want, _ = jax.jit(lambda p, s, b: jax_forward(jspec, jcfg, p, s, b, jax.random.PRNGKey(1),
                                                  train=False))(jp, js, jb)
    tb = dict(_torch(b), v_features=torch.from_numpy(b["v_features"]).to(torch.float8_e4m3fn),
              label=torch.tensor([0, 1, 2]))   # the eval step's loss takes labels
    out = make_eval_step(get_model("film_attn_pt"), cfg)(params, state, tb)
    np.testing.assert_allclose(out["logits"].numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(out["preds"].numpy(), np.asarray(want).argmax(-1))


def _bf16_ulp(v):
    """One bf16 unit in the last place at |v| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(max(abs(float(v)), 2.0 ** -126))) - 7)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_film_trunk_bf16_matches_jax(seed):
    """The trunk in bf16, FiLM affine at the conv output's dtype included,
    against the JAX trunk run op by op (see the module note for the bounds)."""
    _, _, jp, js, cfg, params, state = _setup(compute_dtype="bfloat16")
    jcfg = _setup(compute_dtype="bfloat16")[0]
    r = np.random.default_rng(seed)
    B, T = 3, 6
    feats = np.maximum(r.standard_normal((B, T, 10, 13, 12)), 0).astype(np.float32)
    films = r.standard_normal((B, T, 2 * 16 * 2)).astype(np.float32)
    frame_mask = np.arange(T)[None, :] < np.array([T, 2, 3])[:, None]
    want, _ = jax_film_trunk(jp["trunk"], js["trunk"], jnp.asarray(feats), jnp.asarray(films),
                             jnp.asarray(frame_mask), jcfg, train=False)
    got, _ = film_mod.film_trunk(params["trunk"], state["trunk"], torch.from_numpy(feats),
                                 torch.from_numpy(films), torch.from_numpy(frame_mask), cfg)
    out_dtype = got.dtype
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=BF16_ULPS * _bf16_ulp(np.abs(want).max()))
    assert float((got == want).mean()) >= BF16_EQUAL_SHARE
    assert out_dtype == torch.bfloat16


@pytest.mark.parametrize("T", [6, 4])  # 6: full frame axis; 4: bucket-trimmed
def test_film_attn_logits_bf16_match_jax(T):
    """The whole forward in bf16 against JAX run op by op."""
    jcfg, jspec, jp, js, cfg, params, state = _setup(compute_dtype="bfloat16")
    b = _batch(T, seed=3)
    want, _ = jspec.apply(jp, js, _jax(b), jcfg, train=False, rng=jax.random.PRNGKey(1))
    got, _ = get_model("film_attn_pt").apply(params, state, _torch(b), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=BF16_LOGIT_ATOL)
