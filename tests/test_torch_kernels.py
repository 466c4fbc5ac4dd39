"""Each ported kernel's plain version against its Pallas kernel (interpret mode).

On the CPU a kernel wrapper runs its plain PyTorch version (the CUDA kernel
itself runs only on the card, where chip_smoke.py holds it against the same
plain version). Tolerances: atol 1e-5 for the f32 recurrences (sums in
another order); for the fused int8 matmul the int8 output is bitwise equal
and y agrees at rtol 1e-5 / atol 1e-6, as the JAX package's own test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videonavqa_tpu.kernels.attn_tail_pallas import attn_tail_pallas
from videonavqa_tpu.kernels.film_reencode_pallas import film_reencode_pallas
from videonavqa_tpu.kernels.int8_matmul_pallas import matmul_int8_fused_pallas
from videonavqa_tpu.ops import initializers as jinit
from videonavqa_tpu.ops import quant as jquant
from videonavqa_tpu.ops.masking import attn_frame_mask
from videonavqa_tpu_torch.kernels import _build
from videonavqa_tpu_torch.kernels import attn_tail as attn_mod
from videonavqa_tpu_torch.kernels import film_reencode as reenc_mod
from videonavqa_tpu_torch.kernels import int8_matmul as int8_mod
from videonavqa_tpu_torch.ops.linear import linear

RECURRENCE_ATOL = 1e-5


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("num_frames", [1, 6])
def test_film_reencode_matches_pallas(num_frames):
    B, Tq, E, H = 4, 9, 8, 8
    cell = jinit.reference_lstm(jax.random.PRNGKey(0), E, H)
    r = np.random.default_rng(0)
    emb = r.standard_normal((B, Tq, E)).astype(np.float32)
    lens = np.array([9, 4, 1, 7], np.int32)
    want = film_reencode_pallas(cell, jnp.asarray(emb), jnp.asarray(lens), num_frames,
                                interpret=True)                       # [B, F, H]
    tcell = _t(cell)
    xw = linear({"weight": tcell["w_ih"], "bias": tcell["b_ih"]}, _t(emb))
    before = reenc_mod.launches
    got = reenc_mod.film_reencode(xw.transpose(0, 1).contiguous(), tcell["w_hh"],
                                  tcell["b_hh"], _t(lens), num_frames)  # [F, B, H]
    assert reenc_mod.launches == before  # the CPU runs the plain version
    np.testing.assert_allclose(got.transpose(0, 1).numpy(), np.asarray(want),
                               atol=RECURRENCE_ATOL)


@pytest.mark.parametrize("T", [7, 4])  # 4: a bucket-trimmed frame axis, n_phantom 3
def test_attn_tail_matches_pallas(T):
    B, A, S = 3, 8, 7
    k1, k2 = jax.random.split(jax.random.PRNGKey(2))
    params = {"fc_hidden_attn": jinit.reference_linear(k1, 1, A),
              "lstm_attn": jinit.reference_lstm(k2, A, A)}
    r = np.random.default_rng(1)
    v_lens = np.array([T, 2, 3], np.int32)
    valid = np.arange(T)[None, :] < v_lens[:, None]
    feats = (r.standard_normal((B, T, A)) * valid[..., None]).astype(np.float32)
    scores = np.where(valid, r.standard_normal((B, T)), 0.0).astype(np.float32)
    mask = np.asarray(attn_frame_mask(jnp.asarray(v_lens), T))
    n_phantom = float(S - T)
    want = attn_tail_pallas(params, jnp.asarray(feats), jnp.asarray(scores),
                            jnp.asarray(mask), num_steps=S, n_phantom=n_phantom,
                            interpret=True)
    got = attn_mod.attn_tail(_t(params), _t(feats), _t(scores), _t(mask), S, n_phantom)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=RECURRENCE_ATOL)


@pytest.mark.parametrize("requant", [True, False])
@pytest.mark.parametrize("relu", [True, False])
def test_int8_matmul_fused_matches_pallas(relu, requant):
    r = np.random.default_rng(3)
    cin, cout = 16, 24
    x = r.standard_normal((2, 6, 13, cin)).astype(np.float32)
    w = (r.standard_normal((1, 1, cin, cout)) * 0.3).astype(np.float32)
    bias = r.standard_normal(cout).astype(np.float32)
    wq, sw = jquant.quantize_weight_channelwise(jnp.asarray(w))
    absmax = np.float32(1.25 * np.abs(x).max())
    nxt = np.float32(2.5) if requant else None
    want = matmul_int8_fused_pallas(
        jnp.asarray(x), wq[0, 0], sw, jnp.asarray(bias), jnp.asarray(absmax), relu=relu,
        next_absmax=None if nxt is None else jnp.asarray(nxt), out_dtype=jnp.float32,
        block_rows=64, interpret=True)
    wq_t = torch.from_numpy(np.ascontiguousarray(np.asarray(wq)[0, 0].T))  # [Cout, Cin]
    got = int8_mod.matmul_int8_fused(
        _t(x), wq_t, _t(sw), _t(bias), torch.tensor(absmax), relu=relu,
        next_absmax=None if nxt is None else torch.tensor(nxt), out_dtype=torch.float32)
    if requant:
        (got, gotq), (want, wantq) = got, want
        assert gotq.dtype == torch.int8
        np.testing.assert_array_equal(gotq.numpy(), np.asarray(wantq))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_int8_matmul_plain_is_exact_integer_product():
    """The plain version's int8 product equals an int64 matmul (what the
    kernel's int32 mma accumulation must reproduce)."""
    r = np.random.default_rng(4)
    x = torch.from_numpy(r.standard_normal((37, 64)).astype(np.float32))
    wq = torch.from_numpy(r.integers(-127, 128, (128, 64)).astype(np.int8))
    comb = torch.ones(128)
    y, _ = int8_mod.int8_matmul_plain(x, wq, comb, torch.zeros(128), torch.tensor(0.02),
                                      None, relu=False, out_dtype=torch.float32)
    xq = torch.clamp(torch.round(x / 0.02), -127, 127).long()
    np.testing.assert_array_equal(y.numpy(), (xq @ wq.long().t()).float().numpy())


def test_build_without_nvcc_raises(monkeypatch):
    """No fallback: a kernel that cannot be built raises."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR / "never-built")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("attn_tail")


def test_wrappers_refuse_non_cuda_non_cpu_tensors():
    """A wrapper takes the plain version only for CPU tensors; anything else
    goes to the kernel, which checks its inputs and raises."""
    x = torch.empty((4, 128), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        int8_mod.int8_matmul_2d(x, torch.empty((128, 128), dtype=torch.int8, device="meta"),
                                torch.empty(128, device="meta"),
                                torch.empty(128, device="meta"),
                                torch.empty((), device="meta"))
