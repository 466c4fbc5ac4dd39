"""Each ported kernel's plain version against its Pallas kernel (interpret mode).

On the CPU a kernel wrapper runs its plain PyTorch version (the CUDA kernel
itself runs only on the card, where chip_smoke.py holds it against the same
plain version). Tolerances: atol 1e-5 for the f32 recurrences (sums in
another order); for the fused int8 matmul the int8 output is bitwise equal
and y agrees at rtol 1e-5 / atol 1e-6, as the JAX package's own test.
"""

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videonavqa_tpu.kernels.attn_tail_pallas import attn_tail_pallas
from videonavqa_tpu.kernels.film_reencode_pallas import film_reencode_pallas
from videonavqa_tpu.kernels.int8_matmul_pallas import matmul_int8_fused_pallas
from videonavqa_tpu.kernels.lstm_pallas import lstm_pallas
from videonavqa_tpu.ops import initializers as jinit
from videonavqa_tpu.ops import quant as jquant
from videonavqa_tpu.ops.lstm import lstm as jax_lstm
from videonavqa_tpu.ops.masking import attn_frame_mask
from videonavqa_tpu_torch.kernels import _build
from videonavqa_tpu_torch.kernels import attn_tail as attn_mod
from videonavqa_tpu_torch.kernels import film_reencode as reenc_mod
from videonavqa_tpu_torch.kernels import int8_matmul as int8_mod
from videonavqa_tpu_torch.kernels import lstm as lstm_mod
from videonavqa_tpu_torch.kernels import vgg_block1 as block1_mod
from videonavqa_tpu_torch.ops import initializers as tinit
from videonavqa_tpu_torch.ops import lstm as ops_lstm
from videonavqa_tpu_torch.ops.linear import linear
from videonavqa_tpu_torch.ops.masking import attn_frame_mask as attn_frame_mask_t

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


@pytest.mark.parametrize("B,num_frames", [(1, 1), (1, 5), (4, 3), (7, 2)])
def test_film_reencode_cudnn_yardstick_computes_the_plain_function(B, num_frames):
    """chip_smoke.py times the re-encode kernel against num_frames chained
    torch.nn.LSTM calls (cuDNN on the card) over the question packed by its
    lengths, each from the previous call's (h_n, c_n). On the CPU that
    yardstick equals film_reencode_plain: it times the same function."""
    E, H, Tq = 8, 8, 9
    cell = tinit.reference_lstm(torch.Generator().manual_seed(B), E, H)
    r = np.random.default_rng(20 + B)
    lens = torch.from_numpy(r.integers(1, Tq + 1, B).astype(np.int32))
    lens[0] = Tq
    if B > 1:
        lens[-1] = 1
    emb = torch.from_numpy(r.standard_normal((B, Tq, E)).astype(np.float32))
    xw = linear({"weight": cell["w_ih"], "bias": cell["b_ih"]}, emb)
    want = reenc_mod.film_reencode_plain(xw.transpose(0, 1).contiguous(), cell["w_hh"],
                                         cell["b_hh"], lens, num_frames)
    got = chip_smoke.reencode_library(cell, emb, lens, num_frames)()
    assert got.shape == (num_frames, B, H)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=RECURRENCE_ATOL)


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


@pytest.mark.parametrize("precomputed", [False, True])
@pytest.mark.parametrize("carry", [False, True])
def test_lstm_matches_pallas_and_scan(carry, precomputed):
    """The port's masked LSTM (kernel route; the plain version on the CPU)
    against JAX lstm_pallas in interpret mode and the JAX scan, with given
    h0/c0 and with a precomputed input projection."""
    B, T, E, H = 4, 9, 8, 8
    cell = jinit.reference_lstm(jax.random.PRNGKey(0), E, H)
    r = np.random.default_rng(5)
    x = r.standard_normal((B, T, E)).astype(np.float32)
    lens = np.array([9, 4, 1, 7], np.int32)
    h0 = c0 = None
    if carry:
        h0, c0 = (r.standard_normal((B, H)).astype(np.float32) for _ in range(2))
    j = lambda a: None if a is None else jnp.asarray(a)
    jxw = jnp.asarray(x) @ cell["w_ih"].T + cell["b_ih"] if precomputed else None
    wants = [lstm_pallas(cell, j(x), j(lens), j(h0), j(c0), precomputed_xw=jxw,
                         interpret=True),
             jax_lstm(cell, j(x), j(lens), j(h0), j(c0), precomputed_xw=jxw)]
    t = lambda a: None if a is None else _t(a)
    before = lstm_mod.launches
    outs, (h, c) = ops_lstm.lstm(_t(cell), None if precomputed else _t(x), _t(lens), t(h0),
                                 t(c0), precomputed_xw=t(jxw), use_kernel=True)
    assert lstm_mod.launches == before  # the CPU runs the plain version
    assert outs.shape == (B, T, H)
    for want_outs, (want_h, want_c) in wants:
        np.testing.assert_allclose(outs.numpy(), np.asarray(want_outs), atol=RECURRENCE_ATOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=RECURRENCE_ATOL)
        np.testing.assert_allclose(c.numpy(), np.asarray(want_c), atol=RECURRENCE_ATOL)
    assert float(outs[1, 4:].abs().max()) == 0.0 and float(outs[2, 1:].abs().max()) == 0.0


@pytest.mark.parametrize("num_frames", [1, 3])
def test_lstm_frames_matches_pallas_chained_over_frames(num_frames):
    """The chained wrapper (the plain version on the CPU) against lstm_pallas
    in interpret mode called once a pass with the carry threaded through, as
    the JAX time_multi_hop's scan over frames calls it: every pass's outs
    (zero at t >= len) and the final carry, from non-zero (h0, c0)."""
    B, T, E, H = 4, 9, 8, 8
    cell = jinit.reference_lstm(jax.random.PRNGKey(3), E, H)
    r = np.random.default_rng(7)
    x = r.standard_normal((B, T, E)).astype(np.float32)
    lens = np.array([9, 1, 5, 3], np.int32)
    h0, c0 = (r.standard_normal((B, H)).astype(np.float32) for _ in range(2))
    jxw = jnp.asarray(x) @ cell["w_ih"].T + cell["b_ih"]
    h, c = jnp.asarray(h0), jnp.asarray(c0)
    want = []
    for _ in range(num_frames):
        outs, (h, c) = lstm_pallas(cell, jnp.asarray(x), jnp.asarray(lens), h, c,
                                   precomputed_xw=jxw, interpret=True)
        want.append(np.asarray(outs).transpose(1, 0, 2))          # [T, B, H]
    tcell = _t(cell)
    before = lstm_mod.launches
    got, got_h, got_c = lstm_mod.lstm_frames(
        _t(np.asarray(jxw)).transpose(0, 1).contiguous(), tcell["w_hh"], tcell["b_hh"],
        _t(lens), _t(h0), _t(c0), num_frames)
    assert lstm_mod.launches == before  # the CPU runs the plain version
    assert got.shape == (num_frames, T, B, H)
    np.testing.assert_allclose(got.numpy(), np.stack(want), atol=RECURRENCE_ATOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(h), atol=RECURRENCE_ATOL)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(c), atol=RECURRENCE_ATOL)
    past = np.arange(T)[:, None] >= lens[None, :]                  # [T, B]
    assert float(got.abs().numpy()[:, past].max()) == 0.0


def test_lstm_plain_is_the_route_without_the_kernel():
    """use_kernel=False and the kernel route's CPU branch are the same function."""
    r = np.random.default_rng(6)
    T, B, H = 5, 3, 4
    xw, w_hh, b_hh, h0, c0 = (torch.from_numpy(r.standard_normal(s).astype(np.float32))
                              for s in ((T, B, 4 * H), (4 * H, H), (4 * H,), (B, H), (B, H)))
    lens = torch.tensor([5, 2, 3], dtype=torch.int32)
    a = lstm_mod.lstm(xw, w_hh, b_hh, lens, h0, c0)
    b = lstm_mod.lstm_plain(xw, w_hh, b_hh, lens, h0, c0)
    for got, want in zip(a, b):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(a[1][1].numpy(), a[0][1, 1].numpy())  # h_f = last valid out


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


def test_build_list_names_every_source():
    """build_all starts one nvcc per source at once; a source missing from the
    list would build only at its first launch, inside a timed run."""
    assert sorted(_build.SOURCES) == sorted(p.stem for p in _build.CSRC.glob("*.cu"))


def test_build_name_follows_the_shared_headers(monkeypatch, tmp_path):
    """film_reencode.cu and lstm.cu include csrc/lstm_cluster.cuh: an edit of
    a header gives every library a new name, so none is loaded stale."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._lib_path("k")
    assert _build._lib_path("k") == before
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build._lib_path("k") != before


def test_wrappers_refuse_non_cuda_non_cpu_tensors():
    """A wrapper takes the plain version only for CPU tensors; anything else
    goes to the kernel, which checks its inputs and raises."""
    x = torch.empty((4, 128), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        int8_mod.int8_matmul_2d(x, torch.empty((128, 128), dtype=torch.int8, device="meta"),
                                torch.empty(128, device="meta"),
                                torch.empty(128, device="meta"),
                                torch.empty((), device="meta"))
    m = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        lstm_mod.lstm(m(5, 3, 16), m(16, 4), m(16), m(3, dtype=torch.int32), m(3, 4), m(3, 4))


@pytest.mark.parametrize("B,H", [(33, 64), (4, 6), (2, 60000)])
def test_lstm_kernel_refuses_shapes_it_does_not_take(B, H):
    """Off the CPU the wide kernel takes any batch (its C entry runs it as
    launches of as many rows as shared memory holds) and any hidden size
    (zero-padded to a multiple of 4, as it moves h and W_hh 16 bytes at a
    time): B 33 at hidden 64 and B 4 at hidden 6 reach the input checks,
    which on meta tensors raise only for the device. What the card cannot
    hold, a row of h past one SM's shared memory, is refused with an error,
    not handed to the plain version."""
    m = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device="meta")
    match = "does not fit" if H == 60000 else "CUDA"
    with pytest.raises(ValueError, match=match):
        lstm_mod.lstm(m(5, B, 4 * H), m(4 * H, H), m(4 * H), m(B, dtype=torch.int32),
                      m(B, H), m(B, H))


def test_lstm_plain_matches_pallas_past_a_warp_of_batch_rows():
    """The plain version (the wide kernel's reference on the card) at 33
    batch rows and hidden 64, against lstm_pallas in interpret mode, from
    non-zero (h0, c0): the wide path takes any batch, as the Pallas one."""
    B, T, E, H = 33, 6, 8, 64
    cell = jinit.torch_default_lstm(jax.random.PRNGKey(9), E, H)
    r = np.random.default_rng(11)
    x = r.standard_normal((B, T, E)).astype(np.float32)
    lens = r.integers(1, T + 1, B).astype(np.int32)
    lens[0], lens[1] = T, 1
    h0, c0 = (r.standard_normal((B, H)).astype(np.float32) for _ in range(2))
    want_outs, (want_h, want_c) = lstm_pallas(cell, jnp.asarray(x), jnp.asarray(lens),
                                              jnp.asarray(h0), jnp.asarray(c0), interpret=True)
    tcell = _t(cell)
    xw = linear({"weight": tcell["w_ih"], "bias": tcell["b_ih"]}, _t(x)).transpose(0, 1)
    outs, h, c = lstm_mod.lstm_plain(xw.contiguous(), tcell["w_hh"], tcell["b_hh"], _t(lens),
                                     _t(h0), _t(c0))
    np.testing.assert_allclose(outs.transpose(0, 1).numpy(), np.asarray(want_outs),
                               atol=RECURRENCE_ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=RECURRENCE_ATOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(want_c), atol=RECURRENCE_ATOL)


def test_attn_tail_plain_matches_pallas_at_any_width_and_frame_count():
    """The plain version (the kernel's reference on the card) at an attention
    size that is no multiple of 32 (40, which the kernel pads to 128) and more
    frames than two warp passes (70), against attn_tail_pallas in interpret
    mode."""
    B, T, A, S = 2, 70, 40, 5
    k1, k2 = jax.random.split(jax.random.PRNGKey(4))
    params = {"fc_hidden_attn": jinit.reference_linear(k1, 1, A),
              "lstm_attn": jinit.reference_lstm(k2, A, A)}
    r = np.random.default_rng(12)
    v_lens = np.array([T, 33], np.int32)
    valid = np.arange(T)[None, :] < v_lens[:, None]
    feats = (r.standard_normal((B, T, A)) * valid[..., None]).astype(np.float32)
    scores = np.where(valid, r.standard_normal((B, T)), 0.0).astype(np.float32)
    mask = np.asarray(attn_frame_mask(jnp.asarray(v_lens), T))
    want = attn_tail_pallas(params, jnp.asarray(feats), jnp.asarray(scores),
                            jnp.asarray(mask), num_steps=S, n_phantom=0.0, interpret=True)
    got = attn_mod.attn_tail_plain(_t(params), _t(feats), _t(scores), _t(mask), S, 0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=RECURRENCE_ATOL)


@pytest.mark.parametrize("T,n_phantom", [(7, 0.0), (4, 3.0)])
def test_attn_tail_weights_do_not_depend_on_the_step(T, n_phantom):
    """What the kernel computes: the rank-1 projection v shifts every frame's
    logit and the phantom frames' alike, so the attention weights are
    exp(s_t - M) / (sum_t exp(s_t - M) + n_phantom exp(-M)), s = scores +
    mask, M = max(max_t s_t, 0), at every step; the context and the input
    gates are formed once, and the steps are LSTMCells over that constant
    input. In torch this matches the plain version (which recomputes the
    softmax from v every step) within RECURRENCE_ATOL, masked frames
    (-2^31) and phantom frames included."""
    gen = torch.Generator().manual_seed(T)
    B, A, S = 3, 8, 7
    params = {"fc_hidden_attn": tinit.reference_linear(gen, 1, A),
              "lstm_attn": tinit.reference_lstm(gen, A, A)}
    v_lens = torch.tensor([T, 2, 3], dtype=torch.int32)
    fmask = torch.arange(T)[None, :] < v_lens[:, None]
    feats = torch.randn((B, T, A), generator=gen) * fmask[..., None]
    scores = torch.where(fmask, 3 * torch.randn((B, T), generator=gen), 0.0)
    mask = attn_frame_mask_t(v_lens, T)
    want = attn_mod.attn_tail_plain(params, feats, scores, mask, S, n_phantom)
    s_t = scores + mask
    m = torch.clamp(s_t.amax(dim=1, keepdim=True), min=0.0)
    e = torch.exp(s_t - m)
    coef = e / (e.sum(dim=1, keepdim=True) + n_phantom * torch.exp(-m))
    ctx = torch.einsum("bt,bta->ba", coef, feats)
    h = c = torch.zeros((B, A))
    got = []
    for _ in range(S):
        h, c = ops_lstm.lstm_cell(params["lstm_attn"], ctx, h, c)
        got.append(h)
    np.testing.assert_allclose(torch.stack(got, dim=1).numpy(), want.numpy(),
                               atol=RECURRENCE_ATOL)


@pytest.mark.parametrize("A", [40, 200])
def test_attn_tail_padding_leaves_the_output_unchanged(A):
    """The wrapper zero-pads attention size A to the kernel's 128 or 256
    (``pad_inputs``). The padded parameters run through the plain version
    give the unpadded output: the padded units stay exactly 0 at every step
    (their weights, biases and feature columns are zero, as the w_hid
    entries given here), and
    the real ones agree within 1e-6 (the padding adds exact zeros; only the
    CPU matmul's order over the longer rows differs, measured 1.5e-7)."""
    gen = torch.Generator().manual_seed(A)
    params = {"fc_hidden_attn": tinit.reference_linear(gen, 1, A),
              "lstm_attn": tinit.reference_lstm(gen, A, A)}
    B, T, S = 3, 7, 9
    feats = torch.randn((B, T, A), generator=gen)
    scores = torch.randn((B, T), generator=gen)
    mask = torch.zeros((B, T))
    ap = attn_mod.padded_size(A)
    assert ap == (128 if A <= 128 else 256)
    w_ih, w_hh, bias, padded = attn_mod.pad_inputs(params, feats, ap)
    assert padded.shape == (B, T, ap) and w_ih.shape == (4 * ap, ap)
    w_hid = torch.zeros((1, ap))
    w_hid[:, :A] = params["fc_hidden_attn"]["weight"]
    pp = {"fc_hidden_attn": {"weight": w_hid, "bias": params["fc_hidden_attn"]["bias"]},
          "lstm_attn": {"w_ih": w_ih, "w_hh": w_hh, "b_ih": bias,
                        "b_hh": torch.zeros_like(bias)}}
    got = attn_mod.attn_tail_plain(pp, padded, scores, mask, S, 2.0)
    want = attn_mod.attn_tail_plain(params, feats, scores, mask, S, 2.0)
    assert float(got[..., A:].abs().max()) == 0.0
    np.testing.assert_allclose(got[..., :A].numpy(), want.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("A,T,error", [(64, 35, "CUDA"), (200, 100, "CUDA"),
                                       (257, 35, "CUDA"), (2046, 35, "CUDA"),
                                       (60000, 35, "does not fit"), (128, 0, "bad shape")])
def test_attn_tail_kernel_takes_any_size_it_can_hold(A, T, error):
    """Off the CPU the kernel takes any attention size (padded to 128 or 256
    up to 256, above to a multiple of 4 for the wide chain) and any frame
    count its shared memory holds (its library says how many; chip_smoke.py
    checks the limit on the card): on meta tensors such a shape reaches the
    input checks, which raise only for the device; a row of h past one SM's
    shared memory, or no frame, is refused before any launch."""
    m = lambda *shape: torch.empty(shape, device="meta")
    params = {"fc_hidden_attn": {"weight": m(1, A), "bias": m(1)},
              "lstm_attn": {"w_ih": m(4 * A, A), "w_hh": m(4 * A, A), "b_ih": m(4 * A),
                            "b_hh": m(4 * A)}}
    with pytest.raises(ValueError, match=error):
        attn_mod.attn_tail(params, m(2, T, A), m(2, T), m(2, T), 35, 0.0)


def test_lstm_frames_refuses_shapes_it_does_not_take():
    """Off the CPU: no pass count below 1, and at hidden size 128 no more
    batch rows than the grid's y holds clusters; refused, not handed to the
    plain version."""
    m = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device="meta")
    with pytest.raises(ValueError, match="pass count"):
        lstm_mod.lstm_frames(m(5, 3, 512), m(512, 128), m(512), m(3, dtype=torch.int32),
                             m(3, 128), m(3, 128), 0)
    B = lstm_mod.MAX_BATCH_H128 + 1
    with pytest.raises(ValueError, match="batch rows"):
        lstm_mod.lstm_frames(m(5, B, 512), m(512, 128), m(512), m(B, dtype=torch.int32),
                             m(B, 128), m(B, 128), 2)


def _block1_params(device="cpu"):
    r = np.random.default_rng(8)
    conv = lambda cout, cin: {
        "weight": torch.from_numpy((0.1 * r.standard_normal((cout, cin, 3, 3))).astype(np.float32)),
        "bias": torch.from_numpy((0.1 * r.standard_normal(cout)).astype(np.float32))}
    params = {"conv1_1": conv(64, 3), "conv1_2": conv(64, 64)}
    return {k: {n: t.to(device) for n, t in v.items()} for k, v in params.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vgg_block1_cpu_takes_the_plain_route(dtype):
    """On the CPU the wrapper is the plain version (the kernel is held against
    it on the card by chip_smoke.py): no launch, the same numbers."""
    x = torch.from_numpy(np.random.default_rng(9).random((1, 160, 208, 3), dtype=np.float32))
    params = _block1_params()
    before = block1_mod.launches
    got = block1_mod.vgg_block1(params, x, dtype=dtype)
    assert block1_mod.launches == before
    assert got.shape == (1, 80, 104, 64) and got.dtype == dtype
    want = block1_mod.vgg_block1_plain(params, x, dtype=dtype)
    np.testing.assert_array_equal(got.float().numpy(), want.float().numpy())


@pytest.mark.parametrize("shape", [(1, 160, 208, 4), (2, 80, 104, 3), (160, 208, 3),
                                   (0, 160, 208, 3), (1, 208, 160, 3)])
def test_vgg_block1_refuses_frames_it_does_not_take(shape):
    """Frames are exactly [M, 160, 208, 3]; anything else raises, on the CPU
    too (there is no plain fallback for another shape)."""
    with pytest.raises(ValueError, match="frames must be"):
        block1_mod.vgg_block1(_block1_params(), torch.zeros(shape))


def test_vgg_block1_refuses_other_dtypes_and_non_cuda_tensors():
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        block1_mod.vgg_block1(_block1_params(), torch.zeros((1, 160, 208, 3)),
                              dtype=torch.float16)
    with pytest.raises(ValueError, match="CUDA"):
        block1_mod.vgg_block1(_block1_params("meta"),
                              torch.empty((2, 160, 208, 3), device="meta"))


def test_int8_matmul_kernel_refuses_a_reduction_deeper_than_its_panel():
    """The panel route keeps two int8 row panels [64, K] in shared memory, so
    it takes K up to 1024 in multiples of 128 (N too); a deeper reduction or
    another width goes to the streamed route, not to the plain version: on
    meta tensors it reaches the input checks, which raise only for the
    device."""
    assert int8_mod.panel_route(1024, 1024) and int8_mod.panel_route(128, 128)
    assert not int8_mod.panel_route(128, 2048) and not int8_mod.panel_route(200, 256)
    assert not int8_mod.panel_route(256, 48)
    m = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        int8_mod.int8_matmul_2d(m(4, 2048, dtype=torch.bfloat16), m(128, 2048, dtype=torch.int8),
                                m(128), m(128), m())


def test_film_reencode_kernel_refuses_more_batch_rows_than_its_grid():
    m = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device="meta")
    with pytest.raises(ValueError, match="batch rows"):
        reenc_mod.film_reencode(m(5, 65536, 512), m(512, 128), m(512),
                                m(65536, dtype=torch.int32), 2)


def test_film_attn_refuses_a_hidden_size_its_reencode_kernel_does_not_take():
    """film_attn_pt with the kernels on takes any hidden size the card can
    hold: at hidden 8 its forward off the CPU reaches the re-encode kernel
    (padded to 128), whose input checks raise on meta tensors only for the
    device. What the card cannot hold (a row of h past one SM's shared
    memory, more batch rows than the cluster chain's grid) is refused by the
    shape check that the forward runs before any kernel."""
    from videonavqa_tpu_torch.models import ModelConfig, get_model
    from videonavqa_tpu_torch.train.step import forward

    cfg = ModelConfig(model="film_attn_pt", num_classes=5, vocab_size=11, embed_size=8,
                      hidden_size=8, at_hidden_size=8, num_res_blocks=1,
                      num_res_block_channels=8, num_input_channels=4, max_num_frames=3,
                      max_q_len=5, compute_dtype="float32", use_pallas_kernels=True)
    spec = get_model(cfg.model)
    params, state = spec.init(torch.Generator().manual_seed(0), cfg, "meta")
    m = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device="meta")
    batch = {"v_features": m(2, 3, 10, 13, 4), "v_len": m(2, dtype=torch.int32),
             "question": m(2, 5, dtype=torch.int32), "q_len": m(2, dtype=torch.int32)}
    with pytest.raises(ValueError, match="CUDA"):
        forward(spec, cfg, params, state, batch)
    for H in (8, 128, 300, 2048):
        reenc_mod.check_shape(2, H)
    with pytest.raises(ValueError, match="does not fit"):
        reenc_mod.check_shape(2, 60000)
    with pytest.raises(ValueError, match="batch rows"):
        reenc_mod.check_shape(65536, 8)


@pytest.mark.parametrize("grad_enabled, requires_grad, error", [
    (True, True, "no backward pass"),   # autograd would train through the kernel
    (False, True, "expected a CUDA tensor"),   # no_grad and inference_mode: served
    (True, False, "expected a CUDA tensor"),
])
def test_kernel_input_check_refuses_inputs_that_need_a_gradient(grad_enabled, requires_grad,
                                                                 error):
    """A kernel's outputs carry no grad_fn: with autograd recording, an input
    that requires grad is refused before anything else is checked."""
    t = torch.zeros(4, requires_grad=requires_grad)
    with torch.set_grad_enabled(grad_enabled):
        with pytest.raises((RuntimeError, ValueError), match=error):
            _build.require(t, "x", torch.float32)


def test_kernel_wrapper_refuses_inputs_that_require_grad():
    """The LSTM wrapper on tensors off the CPU (meta here) goes to the kernel's
    input checks, which refuse a train forward's xw (computed from W_ih)."""
    m = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device="meta")
    xw = m(5, 2, 32).requires_grad_(True)
    args = (m(32, 8), m(32), m(2, dtype=torch.int32), m(2, 8), m(2, 8))
    with pytest.raises(RuntimeError, match="no backward pass"):
        lstm_mod.lstm(xw, *args)
    with torch.no_grad(), pytest.raises(ValueError, match="expected a CUDA tensor"):
        lstm_mod.lstm(xw, *args)
