"""The port's train steps of the two per-frame video models, v_only_cnn2d_lstm
and concat2d, against the JAX package's, on the CPU, with the helpers of
tests/test_torch_train.py (its small widths; the frame trunk's widths are
fixed, so the frames are the real 160x208). Torch runs on 2 CPU threads here.

Both models run five [conv3x3 -> train-mode BN -> ReLU -> 2x2 max pool]
stages over every frame: at 160x208 a frame gives 0.5 M ReLU inputs and
0.13 M pool windows at stage 0 alone. The two packages sum in other orders
(each conv; v_only's input BN over the whole clip moves every activation by
~1e-5 relative), and on a few elements a step that small crosses a ReLU's
zero or reorders a pool window's top two: the gradient there jumps, and Adam
turns the sign of every small gradient element into a step of ~lr. The JAX
step does the same against itself: fed the same batches with the two rows
swapped (each row keeping its dropout mask), which changes nothing but its
summation order, it departs from itself as far as the port departs from it.
Each test below therefore also holds the swapped JAX step to its bounds,
which shows they are the reference's own spread. They hold:

- step 1's loss and grad_norm to rtol 1e-5 and the BN state after step 1 to
  GOLDEN_TIGHT_ATOL (tests/test_torch_train.py's bounds): nothing jumps in a
  forward from the same weights;
- step 1's gradients: above the frame trunk within HEAD_GRAD_TOL of the
  largest; each trunk leaf within TRUNK_GRAD_RTOL in relative L2 norm; the
  conv biases, which a train-mode BN follows (their gradient is zero in
  exact arithmetic), under NOISE_GRAD_TOL of the largest;
- steps 2 and 3: each loss to LATER_LOSS_RTOL, and PARAM_SHARE of the
  parameter elements within GOLDEN_ATOL after step 3. (The BN running means
  after step 3 carry the conv biases, which Adam moves on float noise.)

Measured values stand beside each bound: the port's, then the swapped JAX
step's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import (
    GOLDEN_ATOL, GOLDEN_TIGHT_ATOL, SMALL, _bridge, _j, _jax_init, _max_diff, _port_tree_as_jax, _t)

from videonavqa_tpu.models import ModelConfig as JaxConfig
from videonavqa_tpu.models import concat2d as jax_concat_mod
from videonavqa_tpu.models import get_model as jax_get_model
from videonavqa_tpu.ops import conv as jconv
from videonavqa_tpu.train import loss as jloss
from videonavqa_tpu.train import step as jstep
from videonavqa_tpu_torch.cli.common import TRAIN_STEP_OPTIONS
from videonavqa_tpu_torch.models import ModelConfig, get_model
from videonavqa_tpu_torch.models import concat2d as concat_mod
from videonavqa_tpu_torch.ops import conv
from videonavqa_tpu_torch.train import loss, step

MODELS = ("v_only_cnn2d_lstm", "concat2d")
B, T = 2, 4
LOSS_RTOL = 1e-5        # step 1; measured: 4.3e-6 (v_only; concat2d 6.1e-8), 2.4e-6
HEAD_GRAD_TOL = 1e-4    # of the largest; measured: 1.5e-5 (v_only out_linear/weight), 2.0e-5
TRUNK_GRAD_RTOL = 0.2   # per leaf; measured: 5.0e-2 (v_only input_bn/weight), 4.4e-2
NOISE_GRAD_TOL = 5e-5   # of the largest; measured: 3.3e-6, 6.4e-6
LATER_LOSS_RTOL = 2e-3  # steps 2-3; measured: 4.4e-4, 3.7e-4
PARAM_SHARE = 0.98      # within GOLDEN_ATOL after step 3; measured: 99.18%, 99.07%
# Each frame stage's conv bias: a train-mode BN over the frame cancels it.
NOISE_LEAVES = tuple(f"trunk/conv{i}/bias" for i in range(5))


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def video_batch(it, B=B, T=T):
    """Numpy batch ``it``: uint8 frames zero past each v_len (one example runs
    all T), questions zero past q_len."""
    r = np.random.default_rng(300 + it)
    v_len = r.integers(1, T + 1, B).astype(np.int32)
    v_len[0] = T
    q_len = r.integers(1, 10, B).astype(np.int32)
    video = r.integers(0, 256, (B, T, 160, 208, 3)).astype(np.uint8)
    q = r.integers(1, 19, (B, 9)).astype(np.int32)
    for b in range(B):
        video[b, v_len[b]:] = 0
        q[b, q_len[b]:] = 0
    return {"video": video, "question": q, "v_len": v_len, "q_len": q_len,
            "label": r.integers(0, 7, B).astype(np.int32)}


def jax_dropout_mask(key):
    """concat2d's mask as the JAX step draws it from its rng, as the port's
    ``dropout_mask`` returns it (bernoulli(0.5) / 0.5 over [B, 256])."""
    return torch.from_numpy(np.array(
        jax.random.bernoulli(key, 0.5, (B, 256)).astype(jnp.float32) / 0.5))


def _give_masks(monkeypatch, masks):
    """Hand the port's dropout seam the given masks, one a call, in order."""
    def given(generator, shape, keep, device):
        assert generator is not None and keep == 0.5 and tuple(shape) == (B, 256)
        return masks.pop(0)

    monkeypatch.setattr(concat_mod, "dropout_mask", given)


def _swapped_rows(monkeypatch):
    """The JAX concat2d's dropout, made to give each row of a batch whose two
    rows are swapped the mask that row has in the batch as it is."""
    jax_dropout = jax_concat_mod.dropout
    monkeypatch.setattr(jax_concat_mod, "dropout", lambda x, rate, rng, train: jax_dropout(
        x[::-1], rate, rng, train)[::-1])


def _jax_run(model, batches, swap=False):
    """Three JAX steps from the small weights -> (losses, grad_norms, state
    after step 1, params, state); with ``swap`` the rows of every batch are
    swapped (call ``_swapped_rows`` first)."""
    _, jp, js = _jax_init(model)
    jopt = jstep.make_optimizer(1e-3)
    jos = jopt.init(jp)
    jtrain = jstep.make_train_step(jax_get_model(model), JaxConfig(**{**SMALL, "model": model}),
                                   jopt, donate=False, **TRAIN_STEP_OPTIONS[model])
    losses, norms, first_state = [], [], None
    for it, b in enumerate(batches):
        if swap:
            b = {k: v[::-1] for k, v in b.items()}
        jp, js, jos, jm = jtrain(jp, js, jos, _j(b), jax.random.PRNGKey(it))
        losses.append(float(jm["loss"]))
        norms.append(float(jm["grad_norm"]))
        first_state = js if first_state is None else first_state
    return losses, norms, first_state, jp, js


def _port_run(monkeypatch, model, batches):
    """The same three steps in the port, concat2d given JAX's masks."""
    _, jp, js = _jax_init(model)
    params, state = _bridge(jp, js)
    train = step.make_train_step(get_model(model), ModelConfig(**{**SMALL, "model": model}),
                                 step.make_optimizer(params, 1e-3), **TRAIN_STEP_OPTIONS[model])
    _give_masks(monkeypatch, [jax_dropout_mask(jax.random.PRNGKey(it)) for it in range(3)])
    losses, norms, first_state = [], [], None
    for it, b in enumerate(batches):
        state, m = train(params, state, _t(b), torch.Generator().manual_seed(it))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        first_state = _port_tree_as_jax(state) if first_state is None else first_state
    assert all(p.requires_grad and p.is_leaf for p in step.tree_leaves(params))
    return losses, norms, first_state, _port_tree_as_jax(params), _port_tree_as_jax(state)


def _share_within(a_tree, b_tree, atol):
    a, b = dict(step.tree_items(a_tree)), dict(step.tree_items(b_tree))
    d = np.concatenate([np.abs(np.asarray(a[k]) - np.asarray(b[k])).ravel() for k in a])
    return float(np.mean(d <= atol))


@pytest.mark.parametrize("model", MODELS)
def test_frame_model_train_step_matches_jax_for_three_steps(monkeypatch, model):
    """Three steps from the same weights and batches (concat2d's dropout on,
    given JAX's masks) against JAX's make_train_step with the model's harness
    options (mean loss, clip 1.0) and Adam 1e-3; the swapped JAX step held
    to the same bounds."""
    batches = [video_batch(it) for it in range(3)]
    want = _jax_run(model, batches)
    got = _port_run(monkeypatch, model, batches)
    _swapped_rows(monkeypatch)
    for run in (got, _jax_run(model, batches, swap=True)):
        losses, norms, first_state, params, _ = run
        np.testing.assert_allclose(losses[0], want[0][0], rtol=LOSS_RTOL)
        np.testing.assert_allclose(norms[0], want[1][0], rtol=1e-5)
        assert _max_diff(first_state, want[2]) <= GOLDEN_TIGHT_ATOL   # measured 2.0e-6, 1.5e-6
        np.testing.assert_allclose(losses[1:], want[0][1:], rtol=LATER_LOSS_RTOL)
        assert _share_within(params, want[3], GOLDEN_ATOL) >= PARAM_SHARE


def _jax_grads(model, b, key):
    _, jp, js = _jax_init(model)
    jcfg = JaxConfig(**{**SMALL, "model": model})

    def jloss_fn(p):
        logits, _ = jax_get_model(model).apply(p, js, _j(b), jcfg, train=True, rng=key)
        return jloss.cross_entropy_loss(logits, jnp.asarray(b["label"]), reduction="mean")

    return dict(step.tree_items(jax.jit(jax.grad(jloss_fn))(jp)))


@pytest.mark.parametrize("model", MODELS)
def test_frame_model_step1_gradients_match_jax(monkeypatch, model):
    """The train forward's gradients from the same weights (concat2d's mask
    given): above the trunk elementwise, the trunk per leaf, and the conv
    biases zero but for float noise; the swapped JAX step's alike."""
    b = video_batch(5)
    key = jax.random.PRNGKey(5)
    want = _jax_grads(model, b, key)
    _, jp, js = _jax_init(model)
    _give_masks(monkeypatch, [jax_dropout_mask(key)])
    params, state = _bridge(jp, js)
    for p in step.tree_leaves(params):
        p.requires_grad_(True)
    logits, _ = get_model(model).apply(params, state, _t(b),
                                       ModelConfig(**{**SMALL, "model": model}), train=True,
                                       generator=torch.Generator().manual_seed(5))
    loss.cross_entropy_loss(logits, torch.from_numpy(b["label"]), reduction="mean").backward()
    got = {k: _port_tree_as_jax(p.grad) for k, p in step.tree_items(params)}
    _swapped_rows(monkeypatch)
    scale = max(float(np.abs(np.asarray(g)).max()) for g in want.values())
    for grads in (got, _jax_grads(model, {k: v[::-1] for k, v in b.items()}, key)):
        for k, w in want.items():
            g, w = np.asarray(grads[k]), np.asarray(w)
            if k in NOISE_LEAVES:
                assert max(np.abs(g).max(), np.abs(w).max()) <= NOISE_GRAD_TOL * scale, k
            elif k.startswith(("trunk/", "input_bn/")):
                assert np.linalg.norm(g - w) <= TRUNK_GRAD_RTOL * np.linalg.norm(w), k
            else:
                np.testing.assert_allclose(g, w, atol=HEAD_GRAD_TOL * scale, err_msg=k)


def test_max_pool_routes_the_gradient_to_the_first_maximum_as_jax():
    """Exact ties (a flat region of a frame): the whole gradient of a window
    goes to its first maximum in row-major order, on both sides."""
    x = np.array([[1, 3, 2, 2], [3, 3, 2, 2], [0, 5, 7, 1], [5, 5, 1, 7]],
                 np.float32).reshape(1, 4, 4, 1)
    want = np.asarray(jax.grad(lambda v: jnp.sum(jconv.max_pool2d(v)))(jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_(True)
    pooled = conv.max_pool2d(t)
    pooled.sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), want)
    assert t.grad.sum() == 4 and set(np.unique(want)) == {0.0, 1.0}
    # the pool without autograd (serving) gives the same values
    with torch.no_grad():
        assert torch.equal(conv.max_pool2d(t), pooled.detach())
    assert torch.equal(conv.max_pool2d(torch.from_numpy(x)), pooled.detach())


def test_dropout_mask_takes_zero_or_two_and_repeats_for_a_seed():
    draw = lambda seed: concat_mod.dropout_mask(torch.Generator().manual_seed(seed), (6, 256),
                                                0.5, torch.device("cpu"))
    first = draw(1)
    assert first.shape == (6, 256) and first.dtype == torch.float32
    assert set(first.unique().tolist()) == {0.0, 2.0}
    assert 0.4 < float((first == 0).float().mean()) < 0.6
    assert torch.equal(first, draw(1)) and not torch.equal(first, draw(2))


@pytest.mark.parametrize("train, seeded", [(True, False), (False, True)])
def test_concat2d_draws_no_mask_without_a_generator_or_in_eval(monkeypatch, train, seeded):
    """Without a generator the train forward's dropout is the identity (as
    JAX's with no rng), and eval draws nothing: the same logits as eval."""
    _, jp, js = _jax_init("concat2d")
    params, state = _bridge(jp, js)
    cfg = ModelConfig(**{**SMALL, "model": "concat2d"})
    b = _t(video_batch(6, T=2))

    def refuse(*args):
        raise AssertionError("drew a dropout mask")

    with torch.no_grad():
        want, _ = get_model("concat2d").apply(params, state, b, cfg, train=False)
        monkeypatch.setattr(concat_mod, "dropout_mask", refuse)
        gen = torch.Generator().manual_seed(0) if seeded else None
        got, _ = get_model("concat2d").apply(params, state, b, cfg, train=train, generator=gen)
    if not train:
        assert torch.equal(got, want)
    assert got.shape == (B, SMALL["num_classes"]) and bool(torch.isfinite(got).all())


def test_concat2d_train_forward_applies_the_mask_after_fc_tail(monkeypatch):
    """A mask of zeros leaves the output layer its bias alone."""
    _, jp, js = _jax_init("concat2d")
    params, state = _bridge(jp, js)
    monkeypatch.setattr(concat_mod, "dropout_mask",
                        lambda generator, shape, keep, device: torch.zeros(shape))
    with torch.no_grad():
        logits, _ = get_model("concat2d").apply(
            params, state, _t(video_batch(7, T=2)), ModelConfig(**{**SMALL, "model": "concat2d"}),
            train=True, generator=torch.Generator().manual_seed(0))
    for row in logits:
        assert torch.equal(row, params["out_linear"]["bias"].float())


@pytest.mark.parametrize("model", MODELS)
def test_frame_model_train_state_has_jax_keys(model):
    """The train forward's new state: every BN's running statistics, under
    the JAX model's keys, none of them requiring grad."""
    _, jp, js = _jax_init(model)
    params, state = _bridge(jp, js)
    jcfg = JaxConfig(**{**SMALL, "model": model})
    _, want = jax.jit(lambda p, s, b: jax_get_model(model).apply(p, s, b, jcfg, train=True))(
        jp, js, _j(video_batch(8, T=2)))
    with torch.no_grad():
        _, got = get_model(model).apply(params, state, _t(video_batch(8, T=2)),
                                        ModelConfig(**{**SMALL, "model": model}), train=True)
    assert sorted(k for k, _ in step.tree_items(got)) == sorted(k for k, _ in
                                                                step.tree_items(want))
    assert _max_diff(_port_tree_as_jax(got), want) <= GOLDEN_TIGHT_ATOL   # measured 2.4e-7
    # train mode moved every statistic
    assert all(not torch.equal(a, b) for a, b in zip(step.tree_leaves(got),
                                                     step.tree_leaves(state)))
