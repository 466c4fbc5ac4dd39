"""The int8 trunk's requantization source against the JAX package, on the CPU.

The fused int8 1x1 kernel stores its result at the compute dtype and also
hands the next 3x3 conv its int8 input. The JAX package takes that input
from two sources, by route: at or under its INT8_FUSED_MAX_ROWS (9,100
folded rows) its Pallas kernel quantizes the f32 result; above it, its plain
route stores the result and the 3x3 conv quantizes the stored value. In bf16
the two give other codes. The port's trunk runs its fused kernel at every
served count and picks the source by JAX's rule
(``models/film.py INT8_REQUANT_F32_MAX_ROWS``), so its 3x3 convs see JAX's
codes bit for bit on both sides of 9,100: at 4,550 rows (batch 1 x 35
frames) and 13,650 (batch 3 x 35).

The JAX trunk runs op by op (inside one jitted graph XLA may drop the bf16
round trip that is the whole point here), its Pallas kernel in interpret
mode; both trunks run on one calibrated state, JAX's, carried across by
``utils/checkpoint.params_from_jax``. The width is tests/test_kernels.py's
small one, in bf16 (at f32 the two sources agree).
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
from videonavqa_tpu.models import film as jax_film
from videonavqa_tpu.utils.checkpoint import flatten_tree
from videonavqa_tpu_torch.kernels import int8_matmul as int8_mod
from videonavqa_tpu_torch.models import ModelConfig
from videonavqa_tpu_torch.models import film as film_mod
from videonavqa_tpu_torch.ops.quant import act_scale, quantize_act
from videonavqa_tpu_torch.utils.checkpoint import params_from_jax

SMALL = dict(num_classes=7, vocab_size=19, embed_size=8, hidden_size=8, at_hidden_size=8,
             num_res_blocks=1, num_res_block_channels=16, num_input_channels=12,
             num_tail_channels=4, max_num_frames=35, max_q_len=9, compute_dtype="bfloat16")
CH = SMALL["num_res_block_channels"]
T = 35
ROWS = (4550, 13650)   # folded rows B x 35 x 10 x 13: batch 1 and batch 3
BF16_ULPS = 1          # the bf16 trunk bound of tests/test_torch_film_attn.py
BF16_EQUAL_SHARE = 0.99


def _inputs(B, seed):
    r = np.random.default_rng(seed)
    feats = np.maximum(r.standard_normal((B, T, 10, 13, SMALL["num_input_channels"])),
                       0).astype(np.float32)
    films = r.standard_normal((B, T, 2 * CH * SMALL["num_res_blocks"])).astype(np.float32)
    v_len = np.array([T, 21, 9][:B])
    frame_mask = np.arange(T)[None, :] < v_len[:, None]
    return feats, films, frame_mask


@functools.lru_cache(maxsize=None)
def _calibrated():
    """JAX's trunk weights and its calibrated int8 state (int8_scales and the
    pre-quantized int8_wq), and the same carried into the port's layouts."""
    jcfg = JaxConfig(**SMALL)
    jp, js = jax_film.init_film_trunk(jax.random.PRNGKey(0), jcfg)
    feats, films, mask = _inputs(3, seed=7)
    jcal = dataclasses.replace(jcfg, int8_trunk_calibrate=True)
    _, jstate = jax_film.film_trunk(jp, js, jnp.asarray(feats), jnp.asarray(films),
                                    jnp.asarray(mask), jcal, train=False)
    flat = flatten_tree(jp, "params/")
    flat.update(flatten_tree(jstate, "state/"))
    params, state = params_from_jax(flat)
    return jp, jstate, params, state


def _is_block_3x3(wq, hwio):
    shape = tuple(wq.shape)
    return shape == ((3, 3, CH, CH) if hwio else (CH, CH, 3, 3))


def _jax_run(B, monkeypatch):
    """JAX's trunk op by op at B x 35 frames -> (out f32, [3x3 input codes])."""
    jp, jstate, _, _ = _calibrated()
    jq = importlib.import_module("videonavqa_tpu.ops.quant")
    jk = importlib.import_module("videonavqa_tpu.kernels.int8_matmul_pallas")
    codes = []

    def prequant(wq, w_scale, bias, x, act_absmax, **kw):
        if _is_block_3x3(wq, True):
            sx = jnp.maximum(act_absmax.astype(jnp.float32), 1e-8) / 127.0
            codes.append(np.asarray(jnp.clip(jnp.round(x.astype(jnp.float32) / sx),
                                             -127, 127).astype(jnp.int8)))
        return real_prequant(wq, w_scale, bias, x, act_absmax, **kw)

    def preq_act(wq, w_scale, bias, xq, act_absmax, **kw):
        if _is_block_3x3(wq, True):
            codes.append(np.asarray(xq))
        return real_preq_act(wq, w_scale, bias, xq, act_absmax, **kw)

    real_prequant, real_preq_act = jq.conv2d_int8_prequant, jq.conv2d_int8_preq_act
    with monkeypatch.context() as m:
        m.setattr(jq, "conv2d_int8_prequant", prequant)
        m.setattr(jq, "conv2d_int8_preq_act", preq_act)
        m.setattr(jk, "matmul_int8_fused_pallas",
                  functools.partial(jk.matmul_int8_fused_pallas, interpret=True))
        feats, films, mask = _inputs(B, seed=B)
        jcfg = JaxConfig(**SMALL, use_int8_trunk=True, use_pallas_kernels=True)
        out, _ = jax_film.film_trunk(jp, jstate, jnp.asarray(feats), jnp.asarray(films),
                                     jnp.asarray(mask), jcfg, train=False)
    return np.asarray(out.astype(jnp.float32)), codes


def _port_run(B, monkeypatch):
    """The port's trunk at B x 35 frames -> (out f32, [3x3 input codes],
    the fused kernel's calls)."""
    _, _, params, state = _calibrated()
    codes, fused = [], []

    def prequant(wq, w_scale, bias, x, act_absmax, **kw):
        if _is_block_3x3(wq, False):
            codes.append(quantize_act(x, act_scale(act_absmax)).numpy())
        return real_prequant(wq, w_scale, bias, x, act_absmax, **kw)

    def preq_act(wq, w_scale, bias, xq, act_absmax, **kw):
        if _is_block_3x3(wq, False):
            codes.append(xq.numpy())
        return real_preq_act(wq, w_scale, bias, xq, act_absmax, **kw)

    def spy(*a, **kw):
        fused.append(kw)
        return real_fused(*a, **kw)

    real_prequant, real_preq_act = film_mod.conv2d_int8_prequant, film_mod.conv2d_int8_preq_act
    real_fused = film_mod.matmul_int8_fused
    with monkeypatch.context() as m:
        m.setattr(film_mod, "conv2d_int8_prequant", prequant)
        m.setattr(film_mod, "conv2d_int8_preq_act", preq_act)
        m.setattr(film_mod, "matmul_int8_fused", spy)
        feats, films, mask = _inputs(B, seed=B)
        cfg = ModelConfig(**SMALL, use_int8_trunk=True, use_pallas_kernels=True)
        out, _ = film_mod.film_trunk(params, state, torch.from_numpy(feats),
                                     torch.from_numpy(films), torch.from_numpy(mask), cfg)
    assert out.dtype == torch.bfloat16
    return out.float().numpy(), codes, fused


_RUNS = {}


def _runs(rows, monkeypatch):
    """(JAX run, port run) at ``rows`` folded rows, once per process."""
    if rows not in _RUNS:
        B = rows // (T * 130)
        _RUNS[rows] = (_jax_run(B, monkeypatch), _port_run(B, monkeypatch))
    return _RUNS[rows]


@pytest.mark.parametrize("rows", ROWS)
def test_3x3_int8_input_codes_match_jax(rows, monkeypatch):
    """The 3x3 conv's int8 input, bit for bit, on both sides of JAX's 9,100:
    the port's fused kernel ran (once a block) and requantized from the
    source JAX's route at this count uses."""
    (_, want), (_, got, fused) = _runs(rows, monkeypatch)
    assert len(fused) == SMALL["num_res_blocks"]
    assert all(kw["requant_stored"] == (rows > 9100) for kw in fused)
    assert len(got) == len(want) == SMALL["num_res_blocks"]
    for g, w in zip(got, want):
        assert g.shape == (rows // 130, 10, 13, CH)
        np.testing.assert_array_equal(g.reshape(-1), w.reshape(-1))


def _bf16_ulp(v):
    """One bf16 unit in the last place at |v| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(max(abs(float(v)), 2.0 ** -126))) - 7)


@pytest.mark.parametrize("rows", ROWS)
def test_int8_trunk_output_matches_jax(rows, monkeypatch):
    """The int8 trunk's bf16 output within the bf16 trunk bound of JAX's."""
    (want, _), (got, _, _) = _runs(rows, monkeypatch)
    assert got.shape == want.shape == (rows // (T * 130), T, 10, 13, CH)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=BF16_ULPS * _bf16_ulp(np.abs(want).max()))
    assert float((got == want).mean()) >= BF16_EQUAL_SHARE


def test_requant_rule_is_the_jax_gate():
    """The source switches where the JAX package's fused route ends; the
    port's own speed gate stays its H100 measurement."""
    assert film_mod.INT8_REQUANT_F32_MAX_ROWS == jax_film.INT8_FUSED_MAX_ROWS == 9100
    assert film_mod.INT8_FUSED_MAX_ROWS == 256 * 35 * 130


@pytest.mark.parametrize("relu", [True, False])
def test_plain_stored_source_is_quantize_of_the_stored_y(relu):
    """int8_matmul_plain's yq: of y as stored (bf16) with ``requant_stored``,
    of the f32 y without; y itself is the same either way, and at these
    inputs the two sources give other codes somewhere."""
    gen = torch.Generator().manual_seed(4)
    M, K, N = 300, 256, 128
    x = torch.relu(torch.randn((M, K), generator=gen)).to(torch.bfloat16)
    wq = torch.randint(-127, 128, (N, K), generator=gen, dtype=torch.int8)
    comb = torch.rand(N, generator=gen) * 1e-3
    bias = 0.1 * torch.randn(N, generator=gen)
    sx, nx = torch.tensor(0.02), torch.tensor(0.011)
    y32, _ = int8_mod.int8_matmul_plain(x, wq, comb, bias, sx, None, relu=relu,
                                        out_dtype=torch.float32)
    ys, yq_s = int8_mod.int8_matmul_2d(x, wq, comb, bias, sx, nx, relu=relu,
                                       requant_stored=True)
    yf, yq_f = int8_mod.int8_matmul_2d(x, wq, comb, bias, sx, nx, relu=relu)
    assert ys.dtype == yf.dtype == torch.bfloat16
    assert torch.equal(ys, yf) and torch.equal(ys, y32.to(torch.bfloat16))
    assert torch.equal(yq_s, quantize_act(ys.float(), nx))
    assert torch.equal(yq_f, quantize_act(y32, nx))
    assert bool((yq_s != yq_f).any())
    # with an f32 store the stored value is the f32 one
    _, yq32 = int8_mod.int8_matmul_2d(x, wq, comb, bias, sx, nx, relu=relu,
                                      out_dtype=torch.float32, requant_stored=True)
    assert torch.equal(yq32, yq_f)
