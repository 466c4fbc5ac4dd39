"""v_only_cnn3d (the C3D trunk and its zero-run splice) in the PyTorch port
against the JAX package, on the CPU.

Both run the full 160x208x35 geometry that fc6's 7,680 inputs force, at
batch 2 (videos of 7 and 3 frames, uint8, zero past v_len), from the JAX
weights bridged into the port (OIDHW 3-D kernels), with the BN running
statistics perturbed so eval mode is not the identity. What several tests
share (the JAX forward, the port's full-volume trunk) is computed once per
process; torch runs on 2 CPU threads.

Bounds:
- eval logits, every route (full volume, the splice at T 12, the pad path at
  T 24, the precomputed zero-run at T 8 and 16, and at T 34 through
  c3d_trunk_trimmed_cached itself) against the port's full volume and
  against JAX: atol 2e-4 rtol 1e-5 (the JAX trimming test's own bound);
- train mode, full volume against T 12 (the splice; a cached zero-run in the
  state is ignored): logits and BN running statistics atol 1e-5 rtol 1e-4;
- one train step (mean loss, clip 1.0) against JAX's make_train_step, the
  JAX BatchNorm's statistics summed in three levels (``accurate_jax_bn``;
  the JAX package is unchanged): XLA's CPU sum over the 2.3 M values a
  channel of bn_input has here is off float64's by 2.5e-4 relative (torch's
  by 1e-7), and at batch 2 the train step is chaotic under such an error:
  the JAX step itself with its two rows swapped then moves the loss 5.1%
  and the head's gradients by their own size. With the statistics summed in
  levels the swapped JAX step moves the loss 9.1e-5 and the gradients at
  most 7.5e-3 of a leaf's largest (bn7), and the bounds are that spread,
  which the test checks the swapped JAX step meets too: loss LOSS_RTOL,
  the head's gradients (fc6 to fc8 and bn6, bn7) HEAD_GRAD_TOL of each
  leaf's largest, the trunk's TRUNK_GRAD_TOL (measured: the port 7.0e-5,
  5.4e-3 and 1.2e-2, conv1/weight); the port's spliced step (T 12) is held
  to its own full-volume step alike, and the BN running statistics after
  the step to TRAIN_TOL;
- bf16 (the served dtype): the post-bn3 volume within BF16_ULPS bf16 ulp of
  its largest value, at least BF16_EQUAL_SHARE bit-equal, against JAX run op
  by op (tighter than the stem's 3 ulps and 60%: measured 0.99 ulps and
  99.08%).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from videonavqa_tpu.models import ModelConfig as JaxConfig
from videonavqa_tpu.models import get_model as jax_get_model
from videonavqa_tpu.models import v_only_cnn3d as jax_c3d
from videonavqa_tpu.ops import conv as jconv
from videonavqa_tpu.ops import initializers as jinit
from videonavqa_tpu.ops import norm as jnorm
from videonavqa_tpu.train import step as jstep
from videonavqa_tpu.utils import checkpoint as jckpt
from videonavqa_tpu.utils.checkpoint import flatten_tree
from videonavqa_tpu_torch.cli.common import TRAIN_STEP_OPTIONS
from videonavqa_tpu_torch.models import ModelConfig, get_model
from videonavqa_tpu_torch.models import v_only_cnn3d as c3d
from videonavqa_tpu_torch.ops import conv, initializers as init, norm
from videonavqa_tpu_torch.ops.linear import linear
from videonavqa_tpu_torch.ops.video import normalize_video
from videonavqa_tpu_torch.train import step
from videonavqa_tpu_torch.utils import checkpoint as ckpt
from videonavqa_tpu_torch.utils.checkpoint import params_from_jax
from videonavqa_tpu_torch.utils.device import tree_map

SMALL = dict(num_classes=7, vocab_size=19, embed_size=8, hidden_size=128, max_num_frames=35,
             max_q_len=9, compute_dtype="float32")
B = 2
V_LEN = (7, 3)
LOGIT_TOL = dict(atol=2e-4, rtol=1e-5)
TRAIN_TOL = dict(atol=1e-5, rtol=1e-4)
LOSS_RTOL = 2e-4        # one train step; see the module note
HEAD_GRAD_TOL = 1e-2    # of each leaf's largest
TRUNK_GRAD_TOL = 2e-2   # of each leaf's largest
HEAD = ("fc6/", "bn6/", "fc7/", "bn7/", "fc8/", "embed/", "q_lstm/", "fc_tail/", "out_linear/")
LR = 1e-4
BF16_ULPS = 1             # measured: 0.99 ulps
BF16_EQUAL_SHARE = 0.98   # measured: 99.08% bit-equal


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def as_jax_layout(tree):
    """Port tensors -> numpy in the JAX layouts (OIHW -> HWIO, OIDHW -> DHWIO)."""
    if isinstance(tree, dict):
        return {k: as_jax_layout(v) for k, v in tree.items()}
    a = tree.detach().float().numpy() if tree.dtype == torch.bfloat16 else tree.detach().numpy()
    order = {4: (2, 3, 1, 0), 5: (2, 3, 4, 1, 0)}.get(a.ndim)
    return a.transpose(order) if order else a


def setup(model="v_only_cnn3d", compute_dtype="float32"):
    """(jcfg, jp, js, cfg, params, state): the JAX init at SMALL, its BN
    running statistics perturbed, and the same weights in the port."""
    return _setup(model, compute_dtype)


@functools.lru_cache(maxsize=None)
def _setup(model, compute_dtype):
    extra = dict(SMALL, model=model, compute_dtype=compute_dtype)
    jcfg = JaxConfig(**extra)
    jp, js = jax.jit(jax_get_model(model).init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    r = np.random.default_rng(3)
    js = jax.tree.map(lambda x: x + 0.05 * np.abs(r.standard_normal(x.shape)).astype(np.float32),
                      js)
    flat = flatten_tree(jp, "params/")
    flat.update(flatten_tree(js, "state/"))
    params, state = params_from_jax({k: np.asarray(v) for k, v in flat.items()})
    return jcfg, jp, js, ModelConfig(**extra), params, state


@functools.lru_cache(maxsize=None)
def video_batch(seed=0):
    """uint8 frames [B, 35, 160, 208, 3] zero past v_len, questions, labels."""
    r = np.random.default_rng(seed)
    video = r.integers(0, 256, (B, 35, 160, 208, 3)).astype(np.uint8)
    for b, n in enumerate(V_LEN):
        video[b, n:] = 0
    q = r.integers(1, 19, (B, 9)).astype(np.int32)
    q[1, 4:] = 0
    return {"video": video, "v_len": np.array(V_LEN, np.int32), "question": q,
            "q_len": np.array([9, 4], np.int32), "label": r.integers(0, 7, B).astype(np.int32)}


def jax_batch(b, T=35):
    return {k: jnp.asarray(v[:, :T] if k == "video" else v) for k, v in b.items()}


def torch_batch(b, T=35):
    out = {k: torch.from_numpy(np.ascontiguousarray(v[:, :T] if k == "video" else v))
           for k, v in b.items()}
    out["label"] = out["label"].long()
    return out


@functools.lru_cache(maxsize=None)
def jax_eval(model="v_only_cnn3d"):
    """JAX's eval logits of the full volume."""
    jcfg, jp, js, _, _, _ = setup(model)
    spec = jax_get_model(model)
    fn = jax.jit(lambda p, s, b: spec.apply(p, s, b, jcfg, train=False,
                                            rng=jax.random.PRNGKey(1))[0])
    return np.asarray(fn(jp, js, jax_batch(video_batch())))


@functools.lru_cache(maxsize=None)
def port_full_trunk():
    """The port's eval trunk output [B, 128] of the full volume."""
    _, _, _, cfg, params, state = setup()
    with torch.inference_mode():
        h, _ = c3d.c3d_trunk(params, state, normalize_video(torch_batch(video_batch())["video"]),
                             cfg, train=False)
    return h


def port_logits(params, h):
    return linear(params["fc8"], h).numpy()


def spy(monkeypatch, name):
    calls = []
    real = getattr(c3d, name)
    monkeypatch.setattr(c3d, name, lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def test_eval_full_volume_matches_jax():
    _, _, _, _, params, _ = setup()
    got = port_logits(params, port_full_trunk())
    assert got.shape == (B, 7)
    np.testing.assert_allclose(got, jax_eval(), **LOGIT_TOL)


@pytest.mark.parametrize("T, spliced", [(12, True), (24, False)])
def test_trimmed_eval_equals_the_full_volume(T, spliced, monkeypatch):
    """T 12 takes the in-step zero-run splice; T 24 (over SPLICE_MAX_T) pads
    back to the full volume."""
    _, _, _, cfg, params, state = setup()
    monkeypatch.setattr(c3d, "SPLICE_MAX_T", 12)
    calls = spy(monkeypatch, "c3d_trunk_trimmed")
    with torch.inference_mode():
        got, _ = get_model("v_only_cnn3d").apply(params, state,
                                                 torch_batch(video_batch(), T), cfg)
    assert len(calls) == int(spliced)
    np.testing.assert_allclose(got.numpy(), port_logits(params, port_full_trunk()), **LOGIT_TOL)
    np.testing.assert_allclose(got.numpy(), jax_eval(), **LOGIT_TOL)


@functools.lru_cache(maxsize=None)
def zero_runs():
    """The port's and JAX's precomputed zero-run columns at T 8, 16 and 34."""
    jcfg, jp, js, cfg, params, state = setup()
    return (c3d.precompute_c3d_zero_slices(params, state, cfg, [8, 16, 34, 0, 35]),
            jax_c3d.precompute_c3d_zero_slices(jp, js, jcfg, [8, 16, 34]))


def test_precomputed_zero_run_matches_jax():
    got, want = zero_runs()
    assert sorted(got) == sorted(want) == ["T16", "T34", "T8"]
    for T in want:
        assert sorted(got[T]) == sorted(want[T])
        for k, w in want[T].items():
            g = got[T][k].numpy()
            assert g.shape == np.asarray(w).shape, (T, k)
            np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, rtol=1e-5, err_msg=f"{T}/{k}")


@pytest.mark.parametrize("T", [8, 16])
def test_cached_zero_run_eval_equals_the_full_volume(T, monkeypatch):
    _, _, _, cfg, params, state = setup()
    monkeypatch.setattr(c3d, "SPLICE_MAX_T_CACHED", 16)
    cached = spy(monkeypatch, "c3d_trunk_trimmed_cached")
    spliced = spy(monkeypatch, "c3d_trunk_trimmed")
    with torch.inference_mode():
        got, new_state = get_model("v_only_cnn3d").apply(
            params, {**state, "c3d_zero": zero_runs()[0]}, torch_batch(video_batch(), T), cfg)
    assert (len(cached), len(spliced)) == (1, 0)
    assert new_state["c3d_zero"] is zero_runs()[0]
    np.testing.assert_allclose(got.numpy(), port_logits(params, port_full_trunk()), **LOGIT_TOL)
    np.testing.assert_allclose(got.numpy(), jax_eval(), **LOGIT_TOL)


def test_cached_splice_at_34_frames_equals_the_full_volume():
    """Over SPLICE_MAX_T_CACHED the model pads; the cached splice itself is
    still exact there."""
    _, _, _, cfg, params, state = setup()
    video = normalize_video(torch_batch(video_batch(), 34)["video"])
    with torch.inference_mode():
        h, _ = c3d.c3d_trunk_trimmed_cached(params, state, video, cfg, zero_runs()[0]["T34"])
    np.testing.assert_allclose(h.numpy(), port_full_trunk().numpy(), **LOGIT_TOL)


def test_train_mode_trimmed_equals_the_full_volume_and_ignores_the_cache(monkeypatch):
    """The splice's train-mode BN statistics are the full volume's: logits
    and every running statistic alike; a zero-run cached in the state is not
    read (its BN statistics are eval's)."""
    _, _, _, cfg, params, state = setup()
    cached = spy(monkeypatch, "c3d_trunk_trimmed_cached")
    spec = get_model("v_only_cnn3d")
    with torch.no_grad():
        full, st_full = spec.apply(params, state, torch_batch(video_batch()), cfg, train=True)
        trim, st_trim = spec.apply(params, {**state, "c3d_zero": zero_runs()[0]},
                                   torch_batch(video_batch(), 12), cfg, train=True)
    assert not cached
    np.testing.assert_allclose(trim.numpy(), full.numpy(), **TRAIN_TOL)
    st_trim.pop("c3d_zero")
    assert sorted(st_trim) == sorted(st_full) == sorted(state)
    for k in st_full:
        for stat in ("mean", "var"):
            np.testing.assert_allclose(st_trim[k][stat].numpy(), st_full[k][stat].numpy(),
                                       **TRAIN_TOL, err_msg=f"{k}/{stat}")
            assert not torch.equal(st_full[k][stat], state[k][stat]), k


def grad_catcher():
    """An optax transform that applies no update and keeps the (clipped)
    gradients it was given as its state: JAX's make_train_step then returns
    its gradients."""
    return optax.GradientTransformation(
        lambda p: {"g": jax.tree.map(jnp.zeros_like, p)},
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), {"g": g}))


def _level_mean(x):
    """The mean over all axes but the last, summed in three levels of
    ~n^(1/3) terms each."""
    C = x.shape[-1]
    x = x.reshape(-1, C)
    n = x.shape[0]
    k = int(round(n ** (1 / 3))) + 1
    x = jnp.pad(x, ((0, (-n) % (k * k)), (0, 0))).reshape(-1, k, k, C)
    return x.sum(axis=2).sum(axis=1).sum(axis=0) / n


def accurate_jax_bn(params, state, x, *, train, momentum=jnorm.MOMENTUM):
    """The JAX package's batch_norm with its train-mode statistics summed in
    levels (see the module note)."""
    if not train:
        return jnorm.batch_norm(params, state, x, train=False)
    x = x.astype(jnp.float32)
    mean = _level_mean(x)
    var = _level_mean(jnp.square(x - mean))
    n = x.size // x.shape[-1]
    new_state = {"mean": (1 - momentum) * state["mean"] + momentum * mean,
                 "var": (1 - momentum) * state["var"] + momentum * var * (n / max(n - 1, 1))}
    y = (x - mean) * jnp.reciprocal(jnp.sqrt(var + jnorm.EPS))
    return y * params["weight"] + params["bias"], new_state


@functools.lru_cache(maxsize=None)
def jax_step(model, swap=False, key_seed=1):
    """One JAX make_train_step at the model's harness options on the full
    volume (``swap``: its two rows swapped), the BN through
    accurate_jax_bn, its rng PRNGKey(key_seed) -> (loss, grad_norm, {path:
    clipped gradient}, new state)."""
    jcfg, jp, js, _, _, _ = setup(model)
    catcher = grad_catcher()
    b = jax_batch(video_batch())
    if swap:
        b = {k: v[::-1] for k, v in b.items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_c3d, "batch_norm", accurate_jax_bn)
        train = jstep.make_train_step(jax_get_model(model), jcfg, catcher, donate=False,
                                      **TRAIN_STEP_OPTIONS[model])
        _, new_state, opt_state, m = train(jp, js, catcher.init(jp), b,
                                           jax.random.PRNGKey(key_seed))
        grads = {k: np.asarray(v) for k, v in step.tree_items(jax.device_get(opt_state["g"]))}
    return float(m["loss"]), float(m["grad_norm"]), grads, new_state


def port_step(model, T=35, generator=None):
    """One port make_train_step (Adam at LR) from the bridged weights ->
    (loss, grad_norm, {path: clipped gradient, JAX layout}, new state,
    params, optimizer)."""
    _, _, _, cfg, params, state = setup(model)
    params = tree_map(torch.clone, params)
    opt = step.make_optimizer(params, LR)
    train = step.make_train_step(get_model(model), cfg, opt, **TRAIN_STEP_OPTIONS[model])
    new_state, m = train(params, state, torch_batch(video_batch(), T), generator)
    grads = {k: as_jax_layout(p.grad) for k, p in step.tree_items(params)}
    return float(m["loss"]), float(m["grad_norm"]), grads, new_state, params, opt


def assert_step_held(got, want, what):
    """(loss, grad_norm, grads) of one step against another's, to the bounds."""
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL, err_msg=what)
    np.testing.assert_allclose(got[1], want[1], rtol=LOSS_RTOL, err_msg=what)
    assert sorted(got[2]) == sorted(want[2])
    for k, w in want[2].items():
        bound = (HEAD_GRAD_TOL if k.startswith(HEAD) else TRUNK_GRAD_TOL) * \
            max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(got[2][k] - w).max())
        assert err <= bound, f"{what}: {k} {err:.3e} > {bound:.3e}"


def test_bn_statistics_are_float64_s_to_1e6():
    """The port's train-mode BN statistics of the full clip (2.3 M values a
    channel) against float64's: the reason the step's JAX side sums in
    levels (XLA's plain sum: 2.5e-4 off)."""
    x = video_batch()["video"].astype(np.float32).transpose(0, 2, 3, 1, 4) / 255.0
    want = x.reshape(-1, 3).astype(np.float64).var(axis=0)
    mean, var, _ = norm.batch_stats({"mean": torch.zeros(3), "var": torch.ones(3)},
                                    torch.from_numpy(np.ascontiguousarray(x)))
    np.testing.assert_allclose(var.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(_level_mean(jnp.asarray(x))),
                               x.reshape(-1, 3).astype(np.float64).mean(axis=0), rtol=1e-6)


def test_train_step_matches_jax_and_the_checkpoint_crosses_both_ways(tmp_path):
    """The port's step on the full volume against JAX's, and the swapped JAX
    step held to the same bounds; the port's spliced step (T 12) against
    its full-volume one; then the port's e0_ checkpoint (Adam's state
    included) in JAX's loader against JAX's Adam applied to JAX's
    gradients."""
    loss, norm_, grads, new_state, params, opt = port_step("v_only_cnn3d")
    want = jax_step("v_only_cnn3d")
    assert_step_held((loss, norm_, grads), want, "port vs JAX")
    assert_step_held(jax_step("v_only_cnn3d", swap=True), want, "swapped JAX vs JAX")
    assert_step_held(port_step("v_only_cnn3d", 12)[:3], (loss, norm_, grads),
                     "port T12 vs port")
    for k, st in want[3].items():
        for stat in ("mean", "var"):
            np.testing.assert_allclose(new_state[k][stat].numpy(), np.asarray(st[stat]),
                                       **TRAIN_TOL, err_msg=f"{k}/{stat}")

    path = str(tmp_path / "e0_c3d.npz")
    ckpt.save_checkpoint(path, params=params, state=new_state, optimizer=opt,
                         meta={"epoch": 0})
    _, jp, js, _, _, _ = setup()
    jopt = jstep.make_optimizer(LR)
    got_p, got_s, got_o, meta = jckpt.load_checkpoint(path, params_template=jp,
                                                      state_template=js,
                                                      opt_template=jopt.init(jp))
    updates, want_o = jopt.update(jckpt.unflatten_like(jp, want[2]), jopt.init(jp), jp)
    want_p = optax.apply_updates(jp, updates)
    assert meta == {"epoch": 0} and int(got_o.count) == 1
    # Adam's first step is lr * g / (|g| + eps): within 2 lr wherever the
    # gradients differ in sign
    got_flat = dict(step.tree_items(got_p))
    for k, w in step.tree_items(want_p):
        np.testing.assert_allclose(np.asarray(got_flat[k]), np.asarray(w), atol=2 * LR,
                                   err_msg=k)
    got_mu = dict(step.tree_items(got_o.inner_state[0].mu))
    for k, w in step.tree_items(want_o.inner_state[0].mu):
        bound = (HEAD_GRAD_TOL if k.startswith(HEAD) else TRUNK_GRAD_TOL) * \
            float(np.abs(np.asarray(w)).max())
        assert float(np.abs(np.asarray(got_mu[k]) - np.asarray(w)).max()) <= bound, k
    for k, st in want[3].items():
        for stat in ("mean", "var"):
            np.testing.assert_allclose(np.asarray(got_s[k][stat]), np.asarray(st[stat]),
                                       **TRAIN_TOL)


def test_a_jax_checkpoint_with_adam_state_loads_into_the_port(tmp_path):
    """A JAX v_only_cnn3d checkpoint with a mid-run Adam state (one update
    from seeded gradients) passes into the port bit for bit: the 3-D kernels
    and their moments DHWIO -> OIDHW, the step, the lr."""
    _, jp, js, cfg, _, _ = setup()
    jopt = jstep.make_optimizer(3e-4)
    r = np.random.default_rng(9)
    g = jax.tree.map(lambda x: jnp.asarray(r.standard_normal(x.shape).astype(np.float32)), jp)
    updates, jos = jopt.update(g, jopt.init(jp), jp)
    jp1 = optax.apply_updates(jp, updates)
    path = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(path, params=jp1, state=js, opt_state=jos, meta={"epoch": 3})
    params, state = get_model("v_only_cnn3d").init(torch.Generator().manual_seed(1), cfg,
                                                   torch.device("cpu"))
    opt = step.make_optimizer(params, 1e-4)
    meta = ckpt.load_checkpoint(path, params=params, state=state, optimizer=opt)
    assert meta["epoch"] == 3 and opt.param_groups[0]["lr"] == pytest.approx(3e-4)
    assert params["conv2"]["weight"].shape == (128, 64, 3, 3, 3)
    got = {k: as_jax_layout(p) for k, p in step.tree_items(params)}
    for k, w in step.tree_items(jp1):
        np.testing.assert_array_equal(got[k], np.asarray(w), err_msg=k)
    mu = dict(step.tree_items(jos.inner_state[0].mu))
    for k, p in step.tree_items(params):
        np.testing.assert_array_equal(as_jax_layout(opt.state[p]["exp_avg"]), np.asarray(mu[k]))
        assert float(opt.state[p]["step"]) == 1.0
    for k, st in js.items():
        np.testing.assert_array_equal(state[k]["var"].numpy(), np.asarray(st["var"]))


def test_the_zero_run_is_never_written_to_a_checkpoint(tmp_path):
    _, _, _, _, params, state = setup()
    path = str(tmp_path / "c.npz")
    zc = {"T8": {"m1": torch.ones(1, 2, 2, 2, 3)}}
    ckpt.save_checkpoint(path, params=params, state={**state, "c3d_zero": zc})
    flat, _ = ckpt.read_npz(path)
    assert not any("c3d_zero" in k for k in flat)
    target = {**tree_map(torch.zeros_like, state), "c3d_zero": zc}
    ckpt.load_checkpoint(path, params=tree_map(torch.clone, params), state=target)
    assert torch.equal(target["bn1"]["var"], state["bn1"]["var"])
    assert target["c3d_zero"] is zc


def test_max_pool3d_routes_the_gradient_to_the_first_maximum_as_jax():
    """A window of exact ties (the zero-padded tail's constant values): the
    whole gradient goes to its first maximum in (D, H, W) order, on both
    sides; without autograd the pool gives the same values."""
    r = np.random.default_rng(4)
    x = r.integers(0, 3, (2, 4, 6, 9, 3)).astype(np.float32)
    x[0, :2, :2, :4] = 1.0   # one whole window tied
    want = np.asarray(jax.grad(lambda v: jnp.sum(jconv.max_pool3d(v, (2, 2, 4))))(
        jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_(True)
    pooled = conv.max_pool3d(t, (2, 2, 4))
    assert pooled.shape == (2, 2, 3, 2, 3)
    pooled.sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), want)
    assert (want[0, 0, 0, 0] == 1.0).all() and want[0, :2, :2, :4].sum() == 3.0
    with torch.no_grad():
        np.testing.assert_array_equal(conv.max_pool3d(t, (2, 2, 4)).numpy(),
                                      pooled.detach().numpy())
    np.testing.assert_array_equal(pooled.detach().numpy(),
                                  np.asarray(jconv.max_pool3d(jnp.asarray(x), (2, 2, 4))))


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_conv3d_matches_jax(dtype):
    r = np.random.default_rng(5)
    x = r.standard_normal((2, 5, 6, 7, 3)).astype(np.float32)
    w = r.standard_normal((3, 3, 3, 3, 4)).astype(np.float32) * 0.3   # DHWIO
    b = r.standard_normal(4).astype(np.float32)
    jd = None if dtype is None else jnp.bfloat16
    want = np.asarray(jconv.conv3d({"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                                   jnp.asarray(x), dtype=jd).astype(jnp.float32))
    got = conv.conv3d({"weight": torch.from_numpy(w.transpose(4, 3, 0, 1, 2).copy()),
                       "bias": torch.from_numpy(b)}, torch.from_numpy(x),
                      dtype=None if dtype is None else torch.bfloat16)
    assert got.shape == (2, 5, 6, 7, 4) and got.is_contiguous()
    tol = dict(atol=1e-5) if dtype is None else dict(atol=0.1, rtol=2e-2)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def test_conv3d_initializers_take_the_jax_bounds():
    gen = torch.Generator().manual_seed(0)
    p = init.torch_default_conv3d(gen, 3, 3, 3, 64, 128)
    jp = jinit.torch_default_conv3d(jax.random.PRNGKey(0), 3, 3, 3, 64, 128)
    assert p["weight"].shape == (128, 64, 3, 3, 3) and p["bias"].shape == (128,)
    bound = 1.0 / np.sqrt(64 * 27)
    for t, j in ((p["weight"], jp["weight"]), (p["bias"], jp["bias"])):
        assert float(t.abs().max()) <= bound
        assert float(np.abs(np.asarray(j)).max()) <= bound
        assert float(t.abs().max()) > 0.9 * bound
    x = init.reference_conv3d(gen, 3, 3, 3, 8, 16)
    xb = np.sqrt(6.0 / (8 * 27 + 16 * 27))
    assert float(x["weight"].abs().max()) <= xb and not x["bias"].any()


def test_bf16_trunk_matches_jax_op_by_op(monkeypatch):
    """The post-bn3 volume (f32 after the bf16 convs) of the full volume,
    against the JAX trunk run op by op (not jitted: XLA's simplifier may drop
    bf16 round trips inside one graph)."""
    jcfg, jp, js, cfg, params, state = setup(compute_dtype="bfloat16")
    seen = {}

    def capture(side, mod):
        real = mod._c3d_head

        def head(p, s, n, h, *, train):
            seen[side] = h
            return real(p, s, n, h, train=train)

        monkeypatch.setattr(mod, "_c3d_head", head)

    capture("port", c3d)
    capture("jax", jax_c3d)
    b = video_batch()
    with torch.inference_mode():
        c3d.c3d_trunk(params, state, normalize_video(torch_batch(b)["video"]), cfg, train=False)
    with jax.disable_jit():
        jax_c3d.c3d_trunk(jp, js, jax_c3d.normalize_video(jnp.asarray(b["video"])), jcfg,
                          train=False)
    got, want = seen["port"].float().numpy(), np.asarray(seen["jax"], np.float32)
    assert got.shape == want.shape == (B, 10, 6, 1, 128)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= BF16_ULPS * ulp
    assert float((got == want).mean()) >= BF16_EQUAL_SHARE


def test_conv3d_runs_a_batch_whose_output_passes_the_index_limit_in_chunks(monkeypatch):
    """Over MAX_CONV_OUTPUT output elements the batch runs in chunks (the
    card's fast 3-D convs index with 32 bits), with the same result."""
    r = np.random.default_rng(6)
    x = torch.from_numpy(r.standard_normal((5, 4, 5, 6, 3)).astype(np.float32))
    p = {"weight": torch.from_numpy(r.standard_normal((7, 3, 3, 3, 3)).astype(np.float32)),
         "bias": torch.from_numpy(r.standard_normal(7).astype(np.float32))}
    whole = conv.conv3d(p, x)
    calls = []
    real = conv.F.conv3d
    monkeypatch.setattr(conv.F, "conv3d", lambda *a, **k: calls.append(a[0].shape[0]) or
                        real(*a, **k))
    monkeypatch.setattr(conv, "MAX_CONV_OUTPUT", 4 * 5 * 6 * 7 * 2)
    chunked = conv.conv3d(p, x)
    assert calls == [2, 2, 1] and chunked.is_contiguous()
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), atol=1e-5, rtol=1e-6)


def test_splice_gates_are_the_h100_measurement():
    """The port's gates come from its own sweep on the H100 at batch 32
    (chip_smoke.py sweep_splice_gate): the in-step splice beat the full
    volume up to T 24, the cached one up to T 28. The JAX package keeps the
    12 and 16 it measured on a TPU at batch 8."""
    assert (c3d.SPLICE_MAX_T, c3d.SPLICE_MAX_T_CACHED) == (24, 28)
    assert (jax_c3d._SPLICE_MAX_T, jax_c3d._SPLICE_MAX_T_CACHED) == (12, 16)
