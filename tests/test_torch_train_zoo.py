"""The port's train steps of time_multi_hop and MAC against the JAX package's,
on the CPU, with the helpers of tests/test_torch_train.py (its small widths;
MAC at mac_dim 8 and 3 steps, as tests/test_mac_golden.py).

Bounds: each 3-step golden (time_multi_hop: sum CE, clip 1.0; MAC: mean CE,
clip 1.0, the +-1 element clamp, no dropout; Adam 1e-3) holds each loss and
step 1's grad_norm to rtol 1e-5, the parameters and BN state after three
steps to GOLDEN_ATOL and every element to GOLDEN_TIGHT_ATOL but those of the
model's noise leaves and those whose clipped gradient lay under Adam's eps.
MAC with dropout, given the masks JAX draws, holds its logits to atol 1e-5
and step 1's gradients to 1e-5 of the largest. The bf16 train forward of
time_multi_hop holds its loss to rtol 1e-5 and its new bn_init state to atol
1e-6, against JAX run op by op. Measured values stand beside each bound.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import (
    GOLDEN_ATOL, GOLDEN_TIGHT_ATOL, SMALL, _batch, _bridge, _j, _jax_init, _max_diff,
    _port_tree_as_jax, _t)

from videonavqa_tpu.cli.common import mac_lr_for_epoch as jax_mac_lr_for_epoch
from videonavqa_tpu.models import ModelConfig as JaxConfig
from videonavqa_tpu.models import get_model as jax_get_model
from videonavqa_tpu.train import loss as jloss
from videonavqa_tpu.train import step as jstep
from videonavqa_tpu_torch.cli.common import TRAIN_STEP_OPTIONS, mac_lr_for_epoch
from videonavqa_tpu_torch.kernels import lstm as lstm_kernels
from videonavqa_tpu_torch.models import ModelConfig, get_model
from videonavqa_tpu_torch.models import mac as mac_mod
from videonavqa_tpu_torch.train import loss, step

# Leaves whose gradient is zero in exact arithmetic: a bias added to every
# logit of a softmax cancels in it. Adam divides their float noise by its own
# root mean square, which makes steps of up to a tenth of the lr. Measured
# after three steps, every leaf (GOLDEN_ATOL, 5e-4): time_multi_hop 6.2e-5
# (fc_hidden_attn/bias), mac 3.0e-4 (mac/read_attn/bias).
NOISE_LEAVES = {
    # the bias of each hop's word-attention logit
    "time_multi_hop": ("fc_hidden_attn/bias",),
    # the biases of the control unit's word-attention logit and of the read
    # unit's cell-attention logit, and read_concat's bias, which the control
    # scales alike for every cell before that logit
    "mac": ("mac/control_attn/bias", "mac/read_attn/bias", "mac/read_concat/bias"),
}
# An element whose clipped gradient lies under Adam's eps (1e-8) at some step
# takes a step set by the gradient's relative float noise, as a noise leaf
# does: time_multi_hop's sum loss has a raw norm of ~760, so clip 1.0 leaves
# 2,882 of its 12,131 elements there (the largest step apart: 1.9744e-5 on
# out_linear/weight, whose clipped gradient is 3e-9 with 10% noise). Such
# elements are held to GOLDEN_ATOL. Measured, every other element
# (GOLDEN_TIGHT_ATOL, 2e-5), the same at 1, 2, 4, 6 and 8 torch threads:
# time_multi_hop 1.6764e-7 (out_linear/weight), mac 5.7e-7 (conv1/weight); BN
# state 2.9802e-8. Losses within 2.8e-7 (relative), step 1's grad_norm within
# 7.3e-8.
ADAM_EPS = 1e-8
DROPOUT_LOGIT_ATOL = 1e-5  # measured: 3.7e-8
DROPOUT_GRAD_TOL = 1e-5    # of the largest gradient; measured: 1.8e-7 (conv2/bias)
BF16_LOSS_RTOL = 1e-5      # measured: at most 8.9e-8 over three batches
BF16_STATE_ATOL = 1e-6     # measured: 6.0e-8


def _setup(model, **extra):
    """(JAX config, JAX params, JAX state, port config) at the small widths;
    MAC without dropout unless ``extra`` says otherwise. The weights are the
    model's at the small widths whatever ``extra`` says (none of its options
    changes them)."""
    if model == "mac":
        extra = {"mac_dropout": 0.0, **extra}
    _, jp, js = _jax_init(model)
    fields = {**SMALL, **extra, "model": model}
    return JaxConfig(**fields), jp, js, ModelConfig(**fields)


@pytest.mark.parametrize("model", ["time_multi_hop", "mac"])
def test_train_step_matches_jax_for_three_steps(model):
    """Three steps from the same weights and batches against JAX's
    make_train_step with the model's harness options."""
    jcfg, jp, js, cfg = _setup(model)
    params, state = _bridge(jp, js)
    jopt = jstep.make_optimizer(1e-3)
    jopt_state = jopt.init(jp)
    jtrain = jstep.make_train_step(jax_get_model(model), jcfg, jopt, donate=False,
                                   **TRAIN_STEP_OPTIONS[model])
    train = step.make_train_step(get_model(model), cfg, step.make_optimizer(params, 1e-3),
                                 **TRAIN_STEP_OPTIONS[model])
    sub_eps = {k: torch.zeros_like(p, dtype=torch.bool) for k, p in step.tree_items(params)}
    for it in range(3):
        b = _batch(it)
        jp, js, jopt_state, jm = jtrain(jp, js, jopt_state, _j(b), jax.random.PRNGKey(it))
        state, m = train(params, state, _t(b), torch.Generator().manual_seed(it))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_array_equal(m["preds"].numpy(), np.asarray(jm["preds"]))
        if it == 0:
            np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                       rtol=1e-5)
        for k, p in step.tree_items(params):   # p.grad: the clipped gradient
            sub_eps[k] |= p.grad.abs() < ADAM_EPS
    got = _port_tree_as_jax(params)
    assert _max_diff(got, jp) <= GOLDEN_ATOL
    tight = dict(step.tree_items(_port_tree_as_jax(sub_eps)))
    want = dict(step.tree_items(jp))
    for k, v in step.tree_items(got):
        if k not in NOISE_LEAVES[model]:
            d = np.abs(v - np.asarray(want[k]))[~tight[k]]
            assert d.size == 0 or d.max() <= GOLDEN_TIGHT_ATOL, k
    assert _max_diff(_port_tree_as_jax(state), js) <= GOLDEN_TIGHT_ATOL
    assert all(p.requires_grad and p.is_leaf for p in step.tree_leaves(params))


def test_time_multi_hop_bf16_train_forward_matches_jax_op_by_op():
    """The bf16 train forward: its loss and new bn_init state against JAX run
    op by op (inside one jitted graph XLA may drop bf16 round trips)."""
    jcfg, jp, js, cfg = _setup("time_multi_hop", compute_dtype="bfloat16")
    params, state = _bridge(jp, js)
    b = _batch(7)
    logits, jstate = jax_get_model("time_multi_hop").apply(jp, js, _j(b), jcfg, train=True,
                                                           rng=jax.random.PRNGKey(0))
    want = jloss.cross_entropy_loss(logits, jnp.asarray(b["label"]), reduction="sum")
    got_logits, got_state = get_model("time_multi_hop").apply(params, state, _t(b), cfg,
                                                              train=True)
    got = loss.cross_entropy_loss(got_logits, torch.from_numpy(b["label"]), reduction="sum")
    np.testing.assert_allclose(float(got), float(want), rtol=BF16_LOSS_RTOL)
    for k in ("mean", "var"):
        np.testing.assert_allclose(got_state["trunk"]["bn_init"][k].numpy(),
                                   np.asarray(jstate["trunk"]["bn_init"][k]),
                                   atol=BF16_STATE_ATOL)


def test_mac_dropout_matches_jax_given_its_masks(monkeypatch):
    """MAC's train forward with dropout on, given the masks JAX draws from the
    same key: its logits and its gradients."""
    jcfg, jp, js, cfg = _setup("mac", mac_dropout=0.15)
    b = _batch(10)
    key = jax.random.PRNGKey(4)
    keep = 1.0 - 0.15
    n = b["v_features"].shape[0] * b["v_features"].shape[1]
    want_masks = [np.array(jax.random.bernoulli(k, keep, (n, 8)).astype(jnp.float32) / keep)
                  for k in jax.random.split(key)]
    drawn = []

    def jax_masks(generator, n_rows, dim, keep_p, device):
        drawn.append((n_rows, dim, keep_p))
        return tuple(torch.from_numpy(m) for m in want_masks)

    monkeypatch.setattr(mac_mod, "variational_masks", jax_masks)
    jspec = jax_get_model("mac")

    def jloss_fn(p, batch):
        logits, _ = jspec.apply(p, js, batch, jcfg, train=True, rng=key)
        return jloss.cross_entropy_loss(logits, batch["label"], reduction="mean"), logits

    (_, want_logits), jgrads = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(jp, _j(b))
    params, state = _bridge(jp, js)
    for p in step.tree_leaves(params):
        p.requires_grad_(True)
    logits, _ = get_model("mac").apply(params, state, _t(b), cfg, train=True)
    loss.cross_entropy_loss(logits, torch.from_numpy(b["label"]), reduction="mean").backward()
    assert drawn == [(n, 8, keep)]
    assert 0 < sum(int((m == 0).sum()) for m in want_masks)   # some units dropped
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits),
                               atol=DROPOUT_LOGIT_ATOL)
    jgrads = dict(step.tree_items(jgrads))
    scale = max(float(np.abs(np.asarray(g)).max()) for g in jgrads.values())
    for k, p in step.tree_items(params):
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(_port_tree_as_jax(got), np.asarray(jgrads[k]),
                                   atol=DROPOUT_GRAD_TOL * scale, err_msg=k)


def test_variational_masks_take_zero_or_one_over_keep():
    keep = 0.85
    c, m = mac_mod.variational_masks(torch.Generator().manual_seed(1), 40, 16, keep,
                                     torch.device("cpu"))
    for mask in (c, m):
        assert mask.shape == (40, 16) and mask.dtype == torch.float32
        values = set(mask.unique().tolist())
        assert values == {0.0, float(torch.tensor(1.0) / keep)}
    # about mac_dropout of the units dropped
    assert 0.05 < float((torch.stack([c, m]) == 0).float().mean()) < 0.25


def test_variational_masks_repeat_for_a_seed_and_differ_between_rows():
    draw = lambda seed: mac_mod.variational_masks(torch.Generator().manual_seed(seed), 6, 64,
                                                  0.85, torch.device("cpu"))
    first, again, other = draw(2), draw(2), draw(3)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    assert not all(torch.equal(a, b) for a, b in zip(first, other))
    for mask in first:
        assert len({tuple(row.tolist()) for row in mask}) == mask.shape[0]
    assert not torch.equal(first[0], first[1])   # control and memory draw apart
    # without a generator: one seeded 0, as JAX falls back to PRNGKey(0)
    for a, b in zip(mac_mod.variational_masks(None, 6, 64, 0.85, torch.device("cpu")), draw(0)):
        assert torch.equal(a, b)


def test_mac_applies_the_same_masks_at_every_step(monkeypatch):
    """Each checkpointed step gets the masks drawn once for the forward, and
    its new control and memory are zero wherever they are."""
    _, jp, js, cfg = _setup("mac", mac_dropout=0.5)
    params, state = _bridge(jp, js)
    calls, steps = [], []
    draw = mac_mod.variational_masks

    def counted_draw(*args):
        calls.append(draw(*args))
        return calls[-1]

    def recorded_step(fn, i, control, memory, control_mask, memory_mask, use_reentrant):
        out = fn(i, control, memory, control_mask, memory_mask)
        steps.append((control_mask, memory_mask, *out))
        return out

    monkeypatch.setattr(mac_mod, "variational_masks", counted_draw)
    monkeypatch.setattr(mac_mod, "checkpoint", recorded_step)
    get_model("mac").apply(params, state, _t(_batch(11)), cfg, train=True,
                           generator=torch.Generator().manual_seed(6))
    assert len(calls) == 1 and len(steps) == cfg.mac_max_step
    control_mask, memory_mask = calls[0]
    assert bool((control_mask == 0).any()) and bool((memory_mask == 0).any())
    for cm, mm, control, memory in steps:
        assert cm is control_mask and mm is memory_mask
        assert bool((control[control_mask == 0] == 0).all())
        assert bool((memory[memory_mask == 0] == 0).all())


@pytest.mark.parametrize("mac_dropout, train", [(0.0, True), (0.15, False)])
def test_mac_draws_no_mask_without_dropout_or_in_eval(monkeypatch, mac_dropout, train):
    _, jp, js, cfg = _setup("mac", mac_dropout=mac_dropout)
    params, state = _bridge(jp, js)

    def refuse(*args):
        raise AssertionError("drew dropout masks")

    monkeypatch.setattr(mac_mod, "variational_masks", refuse)
    logits, _ = get_model("mac").apply(params, state, _t(_batch(12)), cfg, train=train)
    assert logits.shape == (3, SMALL["num_classes"])


def _mac_grads(cfg, b, seed):
    _, jp, js, _ = _setup("mac")
    params, state = _bridge(jp, js)
    for p in step.tree_leaves(params):
        p.requires_grad_(True)
    logits, _ = get_model("mac").apply(params, state, _t(b), cfg, train=True,
                                       generator=torch.Generator().manual_seed(seed))
    loss.cross_entropy_loss(logits, torch.from_numpy(b["label"]), reduction="mean").backward()
    return {k: (v.grad if v.grad is not None else torch.zeros_like(v))
            for k, v in step.tree_items(params)}


@pytest.mark.parametrize("mac_dropout", [0.0, 0.15])
def test_mac_remat_gives_the_same_gradients(monkeypatch, mac_dropout):
    """The checkpointed steps against the same steps kept whole: bit-equal
    gradients, with dropout on too (a mask redrawn in a recomputed step would
    not be)."""
    b = _batch(13)
    _, _, _, cfg = _setup("mac", mac_dropout=mac_dropout)
    recomputed = []
    real = mac_mod.checkpoint

    def counted(fn, *args, use_reentrant):
        recomputed.append(fn)
        return real(fn, *args, use_reentrant=use_reentrant)

    monkeypatch.setattr(mac_mod, "checkpoint", counted)
    on = _mac_grads(cfg, b, 7)
    assert len(recomputed) == cfg.mac_max_step
    monkeypatch.setattr(mac_mod, "checkpoint", lambda fn, *args, use_reentrant: fn(*args))
    off = _mac_grads(cfg, b, 7)
    for k in off:
        np.testing.assert_array_equal(on[k].numpy(), off[k].numpy(), err_msg=k)
    assert any(float(g.abs().max()) > 0 for g in on.values())


@pytest.mark.parametrize("model", ["time_multi_hop", "mac"])
def test_train_forward_reaches_no_kernel(monkeypatch, model):
    """With use_pallas_kernels on, the train step runs no LSTM kernel entry
    (they have no backward pass), while the eval forward does reach one."""
    _, jp, js, cfg = _setup(model, use_pallas_kernels=True)
    params, state = _bridge(jp, js)

    def refuse(*args, **kwargs):
        raise RuntimeError("a serving kernel was reached")

    for name in ("lstm", "lstm_frames", "_launch"):
        monkeypatch.setattr(lstm_kernels, name, refuse)
    b = _t(_batch(14))
    train = step.make_train_step(get_model(model), cfg, step.make_optimizer(params, 1e-3),
                                 **TRAIN_STEP_OPTIONS[model])
    _, m = train(params, state, b, torch.Generator().manual_seed(0))
    assert np.isfinite(float(m["loss"]))
    with torch.no_grad(), pytest.raises(RuntimeError, match="serving kernel"):
        get_model(model).apply(params, state, b, cfg, train=False)


@pytest.mark.parametrize("epoch", [0, 1, 2, 5])
def test_mac_lr_for_epoch_matches_jax(epoch):
    assert mac_lr_for_epoch(1e-4, epoch) == jax_mac_lr_for_epoch(1e-4, epoch)


def test_train_step_passes_its_generator_to_apply():
    _, jp, js, cfg = _setup("mac", mac_dropout=0.15)
    params, state = _bridge(jp, js)
    spec = get_model("mac")
    seen = []

    def apply(*args, **kwargs):
        seen.append((kwargs["train"], kwargs["generator"]))
        return spec.apply(*args, **kwargs)

    train = step.make_train_step(dataclasses.replace(spec, apply=apply), cfg,
                                 step.make_optimizer(params, 1e-3), **TRAIN_STEP_OPTIONS["mac"])
    gen = torch.Generator().manual_seed(8)
    train(params, state, _t(_batch(15)), gen)
    train(params, state, _t(_batch(15)))
    assert seen == [(True, gen), (True, None)]


def test_eval_step_draws_from_the_generator_it_was_built_with():
    """make_eval_step's step takes (params, state, batch) and passes the
    factory's generator on: the question-only LSTM draws its (h0, c0) from it."""
    cfg = ModelConfig(**{**SMALL, "model": "lstm"})
    spec = get_model("lstm")
    params, state = spec.init(torch.Generator().manual_seed(0), cfg, torch.device("cpu"))
    b = _t(_batch(16))

    def logits(seed):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        return step.make_eval_step(spec, cfg, gen)(params, state, b)["logits"]

    one, two = logits(1), logits(2)
    assert not torch.allclose(one, two)
    assert torch.equal(one, logits(1))
    assert torch.equal(logits(None), logits(0))   # no generator: one seeded 0
