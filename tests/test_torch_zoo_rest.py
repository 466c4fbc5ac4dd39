"""The rest of the zoo in the PyTorch port against the JAX package, on the CPU:
film_gp_pt, the FiLM models' BoW question encoder, the question-only bow and
concat3d.

The same numpy-seeded inputs and the JAX weights, bridged into the port, go
through both; the JAX side reaches its Pallas kernels in interpret mode where
its config asks for them. The FiLM models run at the small widths of
tests/test_frame_trimming.py (2 blocks x 16 channels, embed/hidden 8, 12
input channels, 4 tail channels, 10 frames).

Bounds: f32 logits atol 1e-5 (the trimmed batch against the full one too);
the BoW encoder's FiLM values atol 1e-6 under both padding rules; the static
int8 trunk atol 2e-3 with argmax equal (tests/test_torch_film_attn.py's);
film_gp_pt's 3-step train golden to tests/test_torch_train.py's bounds
(losses and step 1's grad_norm rtol 1e-5, every element of the params and
the BN state GOLDEN_TIGHT_ATOL: no leaf of film_gp_pt has a gradient that is
zero in exact arithmetic, so none takes film_attn_pt's looser GOLDEN_ATOL);
in bf16 the pooled tail (the max over frames of
the bf16 1x1 tail conv) within BF16_ULPS ulps of its largest value and
BF16_EQUAL_SHARE bit-equal against JAX run op by op; bow's logits and
3-step golden 2e-5 everywhere. concat3d runs the C3D's full geometry at
batch 2 with tests/test_torch_cnn3d.py's helpers and bounds.
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
from videonavqa_tpu.models import get_model as jax_get_model
from videonavqa_tpu.train import step as jstep
from videonavqa_tpu.utils.checkpoint import flatten_tree
from videonavqa_tpu_torch.cli.common import TRAIN_STEP_OPTIONS
from videonavqa_tpu_torch.kernels import lstm as lstm_mod
from videonavqa_tpu_torch.models import ModelConfig, get_model
from videonavqa_tpu_torch.models import concat2d as concat_mod
from videonavqa_tpu_torch.models import film as film_mod
from videonavqa_tpu_torch.train import step
from videonavqa_tpu_torch.utils.checkpoint import params_from_jax
from videonavqa_tpu_torch.utils.device import tree_map

import test_torch_cnn3d as c3d_tests
from test_torch_train import GOLDEN_TIGHT_ATOL

SMALL = dict(num_classes=7, vocab_size=19, embed_size=8, hidden_size=8, at_hidden_size=8,
             num_res_blocks=2, num_res_block_channels=16, num_input_channels=12,
             num_tail_channels=4, max_num_frames=10, max_q_len=9, compute_dtype="float32")
LOGIT_ATOL = 1e-5
FILM_VALUES_ATOL = 1e-6
INT8_LOGIT_ATOL = 2e-3
BOW_ATOL = 2e-5
BF16_ULPS = 1
BF16_EQUAL_SHARE = 0.99
ENCODERS = ("lstm", "bow")


@pytest.fixture(autouse=True)
def _interpret_pallas(monkeypatch):
    """Route the JAX package's Pallas kernels through interpret mode."""
    for mod_name, name in (("attn_tail_pallas", "attn_tail_pallas"),
                           ("film_reencode_pallas", "film_reencode_pallas"),
                           ("lstm_pallas", "lstm_pallas"),
                           ("int8_matmul_pallas", "matmul_int8_fused_pallas")):
        mod = importlib.import_module(f"videonavqa_tpu.kernels.{mod_name}")
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name), interpret=True))


def setup(model, **extra):
    return _setup(model, tuple(sorted(extra.items())))


@functools.lru_cache(maxsize=None)
def _setup(model, extra_items):
    """(jcfg, jp, js, cfg, params, state): the JAX init and the same weights
    bridged into the port."""
    extra = {**SMALL, **dict(extra_items), "model": model}
    jcfg = JaxConfig(**extra)
    jp, js = jax.jit(jax_get_model(model).init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    flat = flatten_tree(jp, "params/")
    flat.update(flatten_tree(js, "state/"))
    params, state = params_from_jax(flat)
    return jcfg, jp, js, ModelConfig(**extra), params, state


def batch(T, seed=0, B=3):
    """10 frames of features zero past v_len (5, 2, 4), trimmed to T (from 5
    up the trim is exact), and questions zero past q_len."""
    r = np.random.default_rng(seed)
    v_len = np.array([5, 2, 4][:B], np.int32)
    feats = np.maximum(r.standard_normal((B, 10, 10, 13, 12)), 0).astype(np.float32)
    for b in range(B):
        feats[b, v_len[b]:] = 0.0
    feats = np.ascontiguousarray(feats[:, :T])
    q_len = np.array([9, 4, 6][:B], np.int32)
    q = r.integers(1, 19, (B, 9)).astype(np.int32)
    for b in range(B):
        q[b, q_len[b]:] = 0
    return {"v_features": feats, "question": q, "v_len": v_len, "q_len": q_len,
            "label": r.integers(0, 7, B).astype(np.int32)}


def jx(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def tt(b):
    out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}
    if "label" in out:
        out["label"] = out["label"].long()
    return out


def jax_apply(jcfg, jp, js, b, model):
    """Traced anew in each test, under that test's interpret patch."""
    spec = jax_get_model(model)
    fn = jax.jit(lambda p, s, bb: spec.apply(p, s, bb, jcfg, train=False,
                                             rng=jax.random.PRNGKey(1)))
    return fn(jp, js, jx(b))


def counting(monkeypatch, mod, name):
    calls = []
    real = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


# --- film_gp_pt and the BoW encoder -------------------------------------------

@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("T", [10, 5])   # 10: the full frame axis; 5: bucket-trimmed
@pytest.mark.parametrize("encoder", ENCODERS)
def test_film_gp_logits_match_jax(encoder, T, kernels):
    jcfg, jp, js, cfg, params, state = setup("film_gp_pt", q_encoder=encoder)
    jcfg = dataclasses.replace(jcfg, use_pallas_kernels=kernels)
    cfg = dataclasses.replace(cfg, use_pallas_kernels=kernels)
    b = batch(T)
    want, _ = jax_apply(jcfg, jp, js, b, "film_gp_pt")
    with torch.inference_mode():
        got, _ = get_model("film_gp_pt").apply(params, state, tt(b), cfg)
        full, _ = get_model("film_gp_pt").apply(params, state, tt(batch(10)), cfg)
    assert got.shape == (3, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL)
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=LOGIT_ATOL)


@pytest.mark.parametrize("padding_idx", [0, None])
def test_bow_film_values_match_jax(padding_idx):
    """The BoW encoder: a Linear per token summed over all 9 positions, bias
    at each, the same for every frame. film_gp_pt's padding_idx 0 embeds a
    padded position to zero, which still adds the bias; film_attn_pt's None
    looks up the live row 0. From the init (zero bias) atol 1e-6; with a
    seeded bias, whose nine copies lift the values to ~4, within 1e-6 of
    their size."""
    jcfg, jp, _, cfg, params, _ = setup("film_gp_pt", q_encoder="bow")
    b = batch(6)
    q, q_len = b["question"], b["q_len"]

    def both(jp, params, padding_idx=padding_idx):
        want = jax_film.film_values_over_frames(jp, jnp.asarray(q), jnp.asarray(q_len), 6,
                                                jcfg, padding_idx=padding_idx)
        got = film_mod.film_values_over_frames(params, torch.from_numpy(q),
                                               torch.from_numpy(q_len), 6, cfg,
                                               padding_idx=padding_idx)
        return got, np.asarray(want)

    got, want = both(jp, params)
    assert got.shape == (3, 6, 2 * 16 * 2)
    np.testing.assert_allclose(got.numpy(), want, atol=FILM_VALUES_ATOL)
    assert torch.equal(got[:, 0], got[:, 5])

    bias = np.random.default_rng(1).standard_normal(8).astype(np.float32)
    params = dict(params, encoder=dict(params["encoder"], bias=torch.from_numpy(bias)))
    jp = dict(jp, encoder=dict(jp["encoder"], bias=jnp.asarray(bias)))
    got, want = both(jp, params)
    np.testing.assert_allclose(got.numpy(), want, atol=FILM_VALUES_ATOL * np.abs(want).max())
    other, _ = both(jp, params, None if padding_idx == 0 else 0)
    assert not torch.allclose(got[1:], other[1:])   # rows 1 and 2 hold padding


@pytest.mark.parametrize("kernels", [False, True])
def test_film_attn_with_the_bow_encoder_matches_jax(kernels, monkeypatch):
    """film_attn_pt with --q_encoder bow: the attention tail runs through its
    kernel's wrapper once a forward with the kernels on, the re-encode
    never."""
    jcfg, jp, js, cfg, params, state = setup("film_attn_pt", q_encoder="bow")
    jcfg = dataclasses.replace(jcfg, use_pallas_kernels=kernels)
    cfg = dataclasses.replace(cfg, use_pallas_kernels=kernels)
    tail = counting(monkeypatch, film_mod, "attn_tail")
    reenc = counting(monkeypatch, film_mod, "film_reencode")
    b = batch(10)
    want, _ = jax_apply(jcfg, jp, js, b, "film_attn_pt")
    with torch.inference_mode():
        got, _ = get_model("film_attn_pt").apply(params, state, tt(b), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL)
    assert (len(tail), len(reenc)) == (int(kernels), 0)


@pytest.mark.parametrize("encoder, reencodes", [("lstm", 1), ("bow", 0)])
def test_film_gp_kernel_route_reaches_the_wrappers(encoder, reencodes, monkeypatch):
    """With the kernels and the calibrated int8 trunk: the re-encode once a
    forward (LSTM encoder) and the fused int8 1x1 conv once a block."""
    _, _, _, cfg, params, state = setup("film_gp_pt", q_encoder=encoder)
    b = tt(batch(5))
    with torch.inference_mode():
        _, cal_state = get_model("film_gp_pt").apply(
            params, state, b, dataclasses.replace(cfg, int8_trunk_calibrate=True))
    reenc = counting(monkeypatch, film_mod, "film_reencode")
    fused = counting(monkeypatch, film_mod, "matmul_int8_fused")
    cfg = dataclasses.replace(cfg, use_pallas_kernels=True, use_int8_trunk=True)
    with torch.inference_mode():
        get_model("film_gp_pt").apply(params, cal_state, b, cfg)
    assert (len(reenc), len(fused)) == (reencodes, 2)


@functools.lru_cache(maxsize=None)
def calibrated(encoder):
    """Both sides' calibration forwards on one batch -> (jcfg, jp, JAX state,
    cfg, params, port state)."""
    jcfg, jp, js, cfg, params, state = setup("film_gp_pt", q_encoder=encoder,
                                             use_int8_trunk=True)
    b = batch(5)
    _, jstate = jax_apply(dataclasses.replace(jcfg, int8_trunk_calibrate=True), jp, js, b,
                          "film_gp_pt")
    with torch.inference_mode():
        _, tstate = get_model("film_gp_pt").apply(
            params, state, tt(b), dataclasses.replace(cfg, int8_trunk_calibrate=True))
    return jcfg, jp, jstate, cfg, params, tstate


@pytest.mark.parametrize("fused", [True, False])
def test_film_gp_int8_logits_match_jax(fused):
    """Static int8 serving from each side's calibration, with the fused 1x1
    kernel (3 x 5 x 130 rows are under both packages' gates) and without."""
    jcfg, jp, jstate, cfg, params, tstate = calibrated("lstm")
    b = batch(5, seed=1)
    want, _ = jax_apply(dataclasses.replace(jcfg, use_pallas_kernels=fused), jp, jstate, b,
                        "film_gp_pt")
    with torch.inference_mode():
        got, _ = get_model("film_gp_pt").apply(
            params, tstate, tt(b), dataclasses.replace(cfg, use_pallas_kernels=fused))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=INT8_LOGIT_ATOL)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), np.asarray(want).argmax(-1))


@pytest.mark.parametrize("encoder", ENCODERS)
def test_film_gp_train_step_matches_jax_for_three_steps(encoder):
    """Three steps of the eval.sh preset's options (sum loss, clip 1.0) at
    Adam 1e-3 from the same weights and batches."""
    jcfg, jp, js, cfg, params, state = setup("film_gp_pt", q_encoder=encoder)
    params = tree_map(torch.clone, params)
    opts = TRAIN_STEP_OPTIONS["film_gp_pt"]
    jopt = jstep.make_optimizer(1e-3)
    jos = jopt.init(jp)
    jtrain = jstep.make_train_step(jax_get_model("film_gp_pt"), jcfg, jopt, donate=False, **opts)
    train = step.make_train_step(get_model("film_gp_pt"), cfg, step.make_optimizer(params, 1e-3),
                                 **opts)
    for it in range(3):
        b = batch(10, seed=100 + it)
        jp, js, jos, jm = jtrain(jp, js, jos, jx(b), jax.random.PRNGKey(it))
        state, m = train(params, state, tt(b))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_array_equal(m["preds"].numpy(), np.asarray(jm["preds"]))
        if it == 0:
            np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    got = dict(step.tree_items(c3d_tests.as_jax_layout(params)))
    for k, w in step.tree_items(jp):
        err = float(np.abs(got[k] - np.asarray(w)).max())
        assert err <= GOLDEN_TIGHT_ATOL, (k, err)
    got_state = dict(step.tree_items(c3d_tests.as_jax_layout(state)))
    for k, w in step.tree_items(js):
        assert float(np.abs(got_state[k] - np.asarray(w)).max()) <= GOLDEN_TIGHT_ATOL, k


def test_film_gp_bf16_matches_jax_op_by_op(monkeypatch):
    """The whole forward in bf16 against JAX run op by op: the pooled tail
    (the input of linear_chw) and the logits."""
    jcfg, jp, js, cfg, params, state = setup("film_gp_pt", compute_dtype="bfloat16")
    seen = {}
    for side, mod in (("port", film_mod), ("jax", jax_film)):
        real = mod.linear_chw

        def capture(p, x, side=side, real=real):
            seen.setdefault(side, x)
            return real(p, x)

        monkeypatch.setattr(mod, "linear_chw", capture)
    b = batch(10, seed=3)
    want, _ = jax_get_model("film_gp_pt").apply(jp, js, jx(b), jcfg, train=False)
    with torch.inference_mode():
        got, _ = get_model("film_gp_pt").apply(params, state, tt(b), cfg)
    g, w = seen["port"], seen["jax"]
    assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16 and g.shape == (3, 10, 13, 4)
    g, w = g.float().numpy(), np.asarray(w.astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
    assert np.abs(g - w).max() <= BF16_ULPS * ulp
    assert float((g == w).mean()) >= BF16_EQUAL_SHARE
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL)


# --- bow ----------------------------------------------------------------------

def test_bow_logits_match_jax():
    jcfg, jp, js, cfg, params, state = setup("bow")
    b = batch(1)
    want, _ = jax_apply(jcfg, jp, js, b, "bow")
    got, _ = get_model("bow").apply(params, state, tt(b), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=BOW_ATOL)
    assert not params["embed"]["weight"][0].any()


def test_bow_train_step_matches_jax_for_three_steps():
    """The question-only harness's options (mean loss with class weights, no
    clip) at Adam 1e-3; the padding row stays zero."""
    jcfg, jp, js, cfg, params, state = setup("bow")
    params = tree_map(torch.clone, params)
    weights = (np.random.default_rng(8).random(7) + 0.25).astype(np.float32)
    opts = TRAIN_STEP_OPTIONS["bow"]
    jopt = jstep.make_optimizer(1e-3)
    jos = jopt.init(jp)
    jtrain = jstep.make_train_step(jax_get_model("bow"), jcfg, jopt, donate=False,
                                   class_weights=jnp.asarray(weights), **opts)
    train = step.make_train_step(get_model("bow"), cfg, step.make_optimizer(params, 1e-3),
                                 class_weights=torch.from_numpy(weights), **opts)
    for it in range(3):
        b = batch(1, seed=200 + it)
        jp, js, jos, jm = jtrain(jp, js, jos, jx(b), jax.random.PRNGKey(it))
        _, m = train(params, state, tt(b))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), atol=BOW_ATOL)
    for k, w in step.tree_items(jp):
        np.testing.assert_allclose(dict(step.tree_items(params))[k].detach().numpy(),
                                   np.asarray(w), atol=BOW_ATOL, err_msg=k)
    assert not params["embed"]["weight"][0].any()


# --- concat3d -----------------------------------------------------------------

@pytest.mark.parametrize("T", [35, 12])
def test_concat3d_eval_logits_match_jax(T, monkeypatch):
    """The full volume and the splice at T 12 against JAX's full volume; the
    question LSTM through its kernel's wrapper once a forward."""
    _, _, _, cfg, params, state = c3d_tests.setup("concat3d")
    monkeypatch.setattr(c3d_tests.c3d, "SPLICE_MAX_T", 12)
    calls = counting(monkeypatch, lstm_mod, "lstm")
    with torch.inference_mode():
        got, _ = get_model("concat3d").apply(
            params, state, c3d_tests.torch_batch(c3d_tests.video_batch(), T),
            dataclasses.replace(cfg, use_pallas_kernels=True))
    assert got.shape == (2, 7) and len(calls) == 1
    np.testing.assert_allclose(got.numpy(), c3d_tests.jax_eval("concat3d"),
                               **c3d_tests.LOGIT_TOL)


def test_concat3d_train_step_matches_jax(monkeypatch):
    """One step with dropout 0.5, the port given the mask the JAX step draws
    from its rng, to tests/test_torch_cnn3d.py's step bounds."""
    key_seed = 5
    mask = torch.from_numpy(np.array(
        jax.random.bernoulli(jax.random.PRNGKey(key_seed), 0.5, (2, 256)), np.float32) / 0.5)

    def given(generator, shape, keep, device):
        assert generator is not None and keep == 0.5 and tuple(shape) == (2, 256)
        return mask

    monkeypatch.setattr(concat_mod, "dropout_mask", given)
    loss, norm, grads, new_state, _, _ = c3d_tests.port_step(
        "concat3d", generator=torch.Generator().manual_seed(0))
    want = c3d_tests.jax_step("concat3d", key_seed=key_seed)
    c3d_tests.assert_step_held((loss, norm, grads), want, "concat3d port vs JAX")
    for k, st in want[3].items():
        for stat in ("mean", "var"):
            np.testing.assert_allclose(new_state[k][stat].numpy(), np.asarray(st[stat]),
                                       **c3d_tests.TRAIN_TOL, err_msg=f"{k}/{stat}")


def test_time_multi_hop_ignores_the_q_encoder_flag():
    """The JAX time_multi_hop reads no q_encoder: --q_encoder bow leaves its
    weights and logits as they are, and is not refused."""
    cfg = ModelConfig(**{**SMALL, "model": "time_multi_hop"})
    spec = get_model("time_multi_hop")
    outs = []
    for encoder in ENCODERS:
        c = dataclasses.replace(cfg, q_encoder=encoder)
        params, state = spec.init(torch.Generator().manual_seed(0), c, torch.device("cpu"))
        with torch.inference_mode():
            outs.append(spec.apply(params, state, tt(batch(10)), c)[0])
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("n_phantom", [0.0, 15.0])
def test_the_attention_tail_takes_its_max_over_the_frames(n_phantom):
    """Scores far under v (film_attn_pt with the BoW encoder makes them, at
    its preset and 35 frames): the tail's softmax over the frames and the
    phantom frames, each at v, is the reference's torch softmax; with no
    phantom frame the JAX package's max(max logits, v) would let every exp
    underflow to 0 / 0, which the port's max over the frames does not."""
    from videonavqa_tpu_torch.kernels.attn_tail import attn_tail_plain
    from videonavqa_tpu_torch.ops.linear import linear
    from videonavqa_tpu_torch.ops.lstm import lstm_cell

    _, _, _, _, params, _ = setup("film_attn_pt")
    r = np.random.default_rng(3)
    B, T, A = 2, 6, 8
    feats = torch.from_numpy(r.standard_normal((B, T, A)).astype(np.float32))
    scores = torch.from_numpy((-1e4 * (1 + r.random((B, T)))).astype(np.float32))
    mask = torch.zeros((B, T))
    got = attn_tail_plain(params, feats, scores, mask, 10, n_phantom)
    assert torch.isfinite(got).all()
    h = c = torch.zeros((B, A))
    for step in range(10):
        v = linear(params["fc_hidden_attn"], h)
        logits = torch.cat([v + scores, v.expand(B, int(n_phantom))], dim=1)
        coef = torch.softmax(logits, dim=1)[:, :T]
        h, c = lstm_cell(params["lstm_attn"], torch.einsum("bt,bta->ba", coef, feats), h, c)
        np.testing.assert_allclose(got[:, step].numpy(), h.numpy(), atol=1e-6)
    v = linear(params["fc_hidden_attn"], torch.zeros((B, A)))
    m = torch.maximum((v + scores).amax(dim=1, keepdim=True), v)   # JAX's max
    jax_denom = torch.exp(v + scores - m).sum(dim=1) + n_phantom * torch.exp(v - m)[:, 0]
    assert bool((jax_denom == 0).all()) == (n_phantom == 0.0)
