"""The port's train step (film_attn_pt) against the JAX package's, on the CPU.
(tests/test_torch_train_zoo.py holds time_multi_hop's and MAC's with the
helpers here.)

Inputs are made with numpy from a seed; the JAX weights are bridged into the
port with ``params_from_jax``. The JAX side runs jitted, except the bf16
forward, which runs op by op (inside one jitted graph XLA's simplifier may
drop bf16 round trips; see tests/test_torch_film_attn.py).

Bounds: the train-mode norms agree to atol 1e-6 (outputs and new running
statistics); the loss and the clip to rtol 1e-6; the 3-step golden holds each
loss and step 1's grad_norm to rtol 1e-5, and the parameters and BN state
after three Adam steps to GOLDEN_ATOL, every leaf but NOISE_LEAVES to
GOLDEN_TIGHT_ATOL. The bf16 train forward's loss and new bn_init state are
held to BF16_LOSS_RTOL and BF16_STATE_ATOL. Measured values stand beside each.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videonavqa_tpu.models import ModelConfig as JaxConfig
from videonavqa_tpu.models import get_model as jax_get_model
from videonavqa_tpu.ops import norm as jnorm
from videonavqa_tpu.train import loss as jloss
from videonavqa_tpu.train import step as jstep
from videonavqa_tpu.utils.checkpoint import flatten_tree
from videonavqa_tpu_torch.models import ModelConfig, get_model
from videonavqa_tpu_torch.ops import norm
from videonavqa_tpu_torch.train import loss, step
from videonavqa_tpu_torch.utils.checkpoint import params_from_jax

# The small film_attn_pt of tests/test_torch_film_attn.py; time_multi_hop takes
# the same widths, and MAC those of tests/test_mac_golden.py (mac_dim 8, 3 steps).
SMALL = dict(num_classes=7, vocab_size=19, embed_size=8, hidden_size=8, at_hidden_size=8,
             num_res_blocks=2, num_res_block_channels=16, num_input_channels=12,
             num_tail_channels=4, mac_dim=8, mac_max_step=3, max_num_frames=6, max_q_len=9,
             compute_dtype="float32")
NORM_ATOL = 1e-6
GOLDEN_ATOL = 5e-4        # measured: 3.1e-4 (fc_attn_1/bias)
GOLDEN_TIGHT_ATOL = 2e-5  # measured: 1.0e-6 over the other params, 3.0e-8 over the BN state
# Leaves whose gradient is zero in exact arithmetic on the golden's batches:
# v = fc_hidden_attn(h) shifts every frame's logit alike and cancels in the
# softmax, and fc_attn_1's bias does the same where no frame lies past the
# batch's longest video. Adam divides their float noise (1e-11 to 1e-9) by
# its own root mean square, which makes steps of up to a tenth of the lr.
NOISE_LEAVES = ("fc_hidden_attn/weight", "fc_hidden_attn/bias", "fc_attn_1/bias")
BF16_LOSS_RTOL = 1e-5     # measured: at most 7.8e-7 over three batches
BF16_STATE_ATOL = 1e-6    # measured: 6.0e-8


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _bn_inputs(seed, lens, T=6, dtype=np.float32):
    r = np.random.default_rng(seed)
    C = 5
    p = {"weight": r.standard_normal(C).astype(np.float32),
         "bias": r.standard_normal(C).astype(np.float32)}
    st = {"mean": r.standard_normal(C).astype(np.float32),
          "var": (r.random(C) + 0.5).astype(np.float32)}
    x = (r.standard_normal((len(lens), T, 3, 4, C)) * 2 + 0.5).astype(dtype)
    mask = np.arange(T)[None, :] < np.asarray(lens)[:, None]
    return p, st, x, mask


def _check_frame_outputs(got, want, mask):
    """Valid (b, t) to NORM_ATOL. An invalid one is normalized with its frame's
    valid statistics, and a frame with no valid example with mean 0 and
    variance 0, i.e. x / sqrt(1e-5): values near 1e3, held to a few f32 ulps
    (XLA forms 1/sqrt as one rsqrt, torch as two roundings)."""
    np.testing.assert_allclose(got[mask], want[mask], rtol=0, atol=NORM_ATOL)
    np.testing.assert_allclose(got[~mask], want[~mask], rtol=1e-6, atol=NORM_ATOL)


_jax_frame_bn = jax.jit(functools.partial(jnorm.frame_batch_norm, train=True))
_jax_bn = jax.jit(functools.partial(jnorm.batch_norm, train=True))


@pytest.mark.parametrize("lens", [
    (6, 2, 3),   # one example runs all T frames: K = T
    (4, 2, 3),   # every length below T: frames 4 and 5 have no valid example
    (1, 1, 1),   # one frame processed: one EMA update
])
def test_frame_batch_norm_train_matches_jax(lens):
    p, st, x, mask = _bn_inputs(30, lens)
    want, want_st = _jax_frame_bn(_j(p), _j(st), jnp.asarray(x), jnp.asarray(mask))
    got, got_st = norm.frame_batch_norm(_t(p), _t(st), _t(x), _t(mask), train=True)
    assert got.dtype == torch.float32
    assert np.isfinite(got.numpy()).all()
    _check_frame_outputs(got.numpy(), np.asarray(want), mask)
    for k in ("mean", "var"):
        np.testing.assert_allclose(got_st[k].numpy(), np.asarray(want_st[k]), atol=NORM_ATOL)
        assert not got_st[k].requires_grad


def test_frame_batch_norm_train_takes_f32_statistics_of_bf16_input():
    p, st, x, mask = _bn_inputs(31, (5, 2, 3))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want, want_st = _jax_frame_bn(_j(p), _j(st), jnp.asarray(xb.float().numpy()),
                                  jnp.asarray(mask))
    got, got_st = norm.frame_batch_norm(_t(p), _t(st), xb, _t(mask), train=True)
    assert got.dtype == torch.float32
    _check_frame_outputs(got.numpy(), np.asarray(want), mask)
    for k in ("mean", "var"):
        np.testing.assert_allclose(got_st[k].numpy(), np.asarray(want_st[k]), atol=NORM_ATOL)


def test_batch_norm_train_matches_jax():
    p, st, x, _ = _bn_inputs(32, (1, 1))
    want, want_st = _jax_bn(_j(p), _j(st), jnp.asarray(x))
    got, got_st = norm.batch_norm(_t(p), _t(st), _t(x), train=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=NORM_ATOL)
    for k in ("mean", "var"):
        np.testing.assert_allclose(got_st[k].numpy(), np.asarray(want_st[k]), atol=NORM_ATOL)


@pytest.mark.parametrize("valid", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("reduction", ["sum", "mean", "elementwise_mean"])
def test_cross_entropy_loss_matches_jax(reduction, weighted, valid):
    r = np.random.default_rng(40)
    B, K = 6, 7
    logits = (r.standard_normal((B, K)) * 3).astype(np.float32)
    labels = r.integers(0, K, B).astype(np.int32)
    kw = {}
    if weighted:
        kw["class_weights"] = (r.random(K) + 0.25).astype(np.float32)
    if valid:
        kw["valid"] = np.array([1, 1, 0, 1, 0, 1], bool)
    want = jax.jit(functools.partial(jloss.cross_entropy_loss, reduction=reduction))(
        jnp.asarray(logits), jnp.asarray(labels), **_j(kw))
    got = loss.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                  reduction=reduction, **_t(kw))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_cross_entropy_loss_refuses_an_unknown_reduction():
    with pytest.raises(ValueError, match="unknown reduction"):
        loss.cross_entropy_loss(torch.zeros(2, 3), torch.zeros(2, dtype=torch.long),
                                reduction="none")


@pytest.mark.parametrize("clip_value, clamp, scale", [
    (1.0, None, 1.0),     # the q_and_v models: global-norm clip
    (1.0, 0.05, 1.0),     # MAC: the element clamp, then the clip
    (None, 0.05, 1.0),    # the clamp alone
    (1.0, None, 1e-8),    # a global norm under 1e-6: the clip scale is 1
    (100.0, None, 1.0),   # a norm under the clip value: unchanged
])
def test_clip_grads_matches_jax(clip_value, clamp, scale):
    r = np.random.default_rng(41)
    grads = {"a": (r.standard_normal((4, 3)) * scale).astype(np.float32),
             "b": {"c": (r.standard_normal(5) * scale).astype(np.float32)}}
    want = jax.jit(functools.partial(jstep.clip_grads, clip_value=clip_value,
                                     elementwise_clamp=clamp))(_j(grads))
    got = step.clip_grads([torch.from_numpy(grads["a"]), torch.from_numpy(grads["b"]["c"])],
                          clip_value=clip_value, elementwise_clamp=clamp)
    for g, w in zip(got, (want["a"], want["b"]["c"])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(step.global_norm(got)),
                               float(jnp.sqrt(sum(jnp.sum(jnp.square(w))
                                                  for w in jax.tree.leaves(want)))),
                               rtol=1e-6)


@functools.lru_cache(maxsize=None)
def _jax_init(model="film_attn_pt", **extra):
    jcfg = JaxConfig(**{**SMALL, **extra, "model": model})
    jp, js = jax.jit(jax_get_model(model).init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, js


def _bridge(jp, js):
    """Fresh port (params, state) CPU tensors of the JAX trees."""
    flat = flatten_tree(jp, "params/")
    flat.update(flatten_tree(js, "state/"))
    return params_from_jax({k: np.asarray(v) for k, v in flat.items()})


def _batch(it, B=3, T=6):
    """Numpy batch ``it`` of the golden: sorted v_len, padded features zero."""
    r = np.random.default_rng(100 + it)
    v_len = np.sort(r.integers(1, T + 1, B))[::-1].astype(np.int32)
    q_len = r.integers(1, 10, B).astype(np.int32)
    v = (r.standard_normal((B, T, 10, 13, 12)) * 0.5).astype(np.float32)
    for b in range(B):
        v[b, v_len[b]:] = 0.0
    q = r.integers(1, 19, (B, 9)).astype(np.int32)
    for b in range(B):
        q[b, q_len[b]:] = 0
    label = r.integers(0, 7, B).astype(np.int32)
    return {"v_features": v, "question": q, "v_len": v_len, "q_len": q_len, "label": label}


def _max_diff(a_tree, b_tree, skip=()):
    a = dict(step.tree_items(a_tree))
    b = dict(step.tree_items(b_tree))
    assert sorted(a) == sorted(b)
    return max((float(np.max(np.abs(np.asarray(a[k]) - np.asarray(b[k]))))
                for k in a if k not in skip), default=0.0)


def _port_tree_as_jax(tree):
    """Port (OIHW) tensors -> numpy in the JAX layout (HWIO) for comparison."""
    if isinstance(tree, dict):
        return {k: _port_tree_as_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_port_tree_as_jax(v) for v in tree]
    a = tree.detach().numpy()
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a


def test_film_attn_train_step_matches_jax_for_three_steps():
    """Three steps of sum-CE, clip 1.0 and Adam(1e-3) from the same weights
    and batches, as tests/test_film_attn_golden.py's train-step golden runs
    the JAX step against torch's own modules."""
    jcfg, jp, js = _jax_init()
    params, state = _bridge(jp, js)
    spec = get_model("film_attn_pt")
    cfg = ModelConfig(**SMALL)
    jopt = jstep.make_optimizer(1e-3)
    jopt_state = jopt.init(jp)
    jtrain = jstep.make_train_step(jax_get_model("film_attn_pt"), jcfg, jopt, reduction="sum",
                                   clip_value=1.0, donate=False)
    opt = step.make_optimizer(params, 1e-3)
    train = step.make_train_step(spec, cfg, opt, reduction="sum", clip_value=1.0)
    for it in range(3):
        b = _batch(it)
        jp, js, jopt_state, jm = jtrain(jp, js, jopt_state, _j(b), jax.random.PRNGKey(it))
        state, m = train(params, state, _t(b))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_array_equal(m["preds"].numpy(), np.asarray(jm["preds"]))
        assert int(m["hits"]) == int(jm["hits"])
        if it == 0:
            np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                       rtol=1e-5)
    got_params = _port_tree_as_jax(params)
    assert _max_diff(got_params, jp) <= GOLDEN_ATOL
    assert _max_diff(got_params, jp, skip=NOISE_LEAVES) <= GOLDEN_TIGHT_ATOL
    assert _max_diff(_port_tree_as_jax(state), js) <= GOLDEN_TIGHT_ATOL
    assert all(p.requires_grad and p.is_leaf for p in step.tree_leaves(params))


def _port_grads(cfg, b):
    _, jp, js = _jax_init()
    params, state = _bridge(jp, js)
    for p in step.tree_leaves(params):
        p.requires_grad_(True)
    logits, _ = get_model("film_attn_pt").apply(params, state, _t(b), cfg, train=True)
    l = loss.cross_entropy_loss(logits, torch.from_numpy(b["label"]), reduction="sum")
    l.backward()
    return {k: (v.grad if v.grad is not None else torch.zeros_like(v))
            for k, v in step.tree_items(params)}


def test_remat_film_blocks_gives_the_same_gradients():
    b = _batch(5)
    cfg = ModelConfig(**SMALL)
    off = _port_grads(cfg, b)
    on = _port_grads(dataclasses.replace(cfg, remat_film_blocks=True), b)
    for k in off:
        np.testing.assert_array_equal(on[k].numpy(), off[k].numpy(), err_msg=k)


def test_freeze_film_conv1x1_gives_zero_gradients_as_jax_does():
    b = _batch(6)
    jcfg, jp, js = _jax_init(freeze_film_conv1x1=True)
    spec = jax_get_model("film_attn_pt")

    def jloss_fn(p, s, batch):
        logits, _ = spec.apply(p, s, batch, jcfg, train=True, rng=jax.random.PRNGKey(0))
        return jloss.cross_entropy_loss(logits, batch["label"], reduction="sum")

    jgrads = dict(step.tree_items(jax.jit(jax.grad(jloss_fn))(jp, js, _j(b))))
    got = _port_grads(ModelConfig(**SMALL, freeze_film_conv1x1=True), b)
    frozen = [k for k in got if k.startswith("trunk/conv1x1_")]
    assert len(frozen) == 2 * SMALL["num_res_blocks"]
    for k in frozen:
        assert float(np.abs(np.asarray(jgrads[k])).max()) == 0.0
        assert float(got[k].abs().max()) == 0.0
    # the other gradients: within 1e-5 of the largest (measured 7.7e-7)
    scale = max(float(np.abs(np.asarray(g)).max()) for g in jgrads.values())
    for k, g in got.items():
        w = np.asarray(jgrads[k])
        np.testing.assert_allclose(_port_tree_as_jax(g), w, atol=1e-5 * scale, err_msg=k)


def test_bf16_train_forward_matches_jax_op_by_op():
    """The bf16 train forward: its loss and new bn_init state against JAX run
    op by op."""
    jcfg, jp, js = _jax_init(compute_dtype="bfloat16")
    params, state = _bridge(jp, js)
    b = _batch(7)
    logits, jstate = jax_get_model("film_attn_pt").apply(jp, js, _j(b), jcfg, train=True,
                                                         rng=jax.random.PRNGKey(0))
    want = jloss.cross_entropy_loss(logits, jnp.asarray(b["label"]), reduction="sum")
    cfg = ModelConfig(**SMALL | {"compute_dtype": "bfloat16"})
    got_logits, got_state = get_model("film_attn_pt").apply(params, state, _t(b), cfg,
                                                            train=True)
    got = loss.cross_entropy_loss(got_logits, torch.from_numpy(b["label"]), reduction="sum")
    np.testing.assert_allclose(float(got), float(want), rtol=BF16_LOSS_RTOL)
    for k in ("mean", "var"):
        np.testing.assert_allclose(got_state["trunk"]["bn_init"][k].numpy(),
                                   np.asarray(jstate["trunk"]["bn_init"][k]),
                                   atol=BF16_STATE_ATOL)


@pytest.mark.parametrize("model", ["film_attn_pt", "time_multi_hop", "mac"])
def test_train_step_from_video_runs_the_stem_without_gradient(model):
    """The video form: frames /255, then ``stem_fn`` under no_grad, then the
    same step as from its features (MAC's dropout masks from the same
    generator seed in both)."""
    _, jp, js = _jax_init(model)
    b = _batch(8)
    r = np.random.default_rng(9)
    video = r.integers(0, 256, (3, 6, 4, 5, 3)).astype(np.uint8)
    seen = []

    def stem_fn(frames):
        seen.append((frames.dtype, float(frames.max()), torch.is_grad_enabled()))
        return torch.from_numpy(b["v_features"])

    results = []
    for batch, fn in ((dict(b), None),
                      ({k: v for k, v in b.items() if k != "v_features"} | {"video": video},
                       stem_fn)):
        params, state = _bridge(jp, js)
        opt = step.make_optimizer(params, 1e-3)
        train = step.make_train_step(get_model(model), ModelConfig(**SMALL, model=model), opt,
                                     reduction="sum", clip_value=1.0, stem_fn=fn)
        new_state, m = train(params, state, _t(batch), torch.Generator().manual_seed(3))
        results.append((float(m["loss"]), params, new_state))
    assert seen == [(torch.float32, float(video.max()) / 255.0, False)]
    assert results[0][0] == results[1][0]
    for k in (1, 2):   # params and state
        assert _max_diff(_port_tree_as_jax(results[0][k]), _port_tree_as_jax(results[1][k])) == 0.0


def test_train_step_refuses_params_that_are_not_the_optimizers():
    _, jp, js = _jax_init()
    params, state = _bridge(jp, js)
    opt = step.make_optimizer(params, 1e-3)
    train = step.make_train_step(get_model("film_attn_pt"), ModelConfig(**SMALL), opt)
    other, _ = _bridge(jp, js)
    with pytest.raises(ValueError, match="not the optimizer's"):
        train(other, state, _t(_batch(0)))


def test_set_learning_rate_sets_every_group():
    a, b = torch.zeros(2), torch.zeros(3)
    opt = torch.optim.Adam([{"params": [a]}, {"params": [b]}], lr=1.0)
    step.set_learning_rate(opt, 1e-5)
    assert [g["lr"] for g in opt.param_groups] == [1e-5, 1e-5]
