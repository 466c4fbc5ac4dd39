"""The five zoo models that run the LSTM kernel, in the PyTorch port against the
JAX package, on the CPU.

The same numpy-seeded inputs and the JAX weights, bridged into the port, go
through both, at small width, in f32. Both sides run with
``use_pallas_kernels`` on: the JAX side reaches ``lstm_pallas`` (and, for the
int8 trunk, the fused int8 kernel) in interpret mode, the port's wrappers
take their plain versions because the tensors lie on the CPU. Logits agree
to atol 1e-4 (the JAX package's own wiring tolerance), on the full frame
axis and on a bucket-trimmed one; time_multi_hop with the calibrated int8
trunk to atol 2e-3 with equal argmax (one int8 step at a rounding boundary).
The engine is held against JAX apply + softmax on the same padded batch.

time_multi_hop also runs in bf16, the served dtype, against JAX run op by op
(inside one jitted graph XLA's simplifier may drop bf16 round trips): its
bf16 tail features (the pooled input of the output layer) lie within one bf16
ulp of the largest with at least 99% bit-equal (measured: 0 ulps, 100% equal
over four seeds; casting the FiLM affine in f32 instead of the conv output's
dtype leaves 70-77% equal), and its logits agree to atol 1e-5 (measured at
most 9.5e-7; with the affine in f32, ~1e-2).
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
from videonavqa_tpu.models import time_multi_hop as jax_tmh
from videonavqa_tpu.utils.checkpoint import flatten_tree
from videonavqa_tpu_torch.kernels import lstm as lstm_mod
from videonavqa_tpu_torch.models import ModelConfig, get_model
from videonavqa_tpu_torch.models import q_only_lstm
from videonavqa_tpu_torch.models import time_multi_hop as tmh_mod
from videonavqa_tpu_torch.serve.engine import InferenceEngine
from videonavqa_tpu_torch.train.step import forward
from videonavqa_tpu_torch.utils.checkpoint import params_from_jax

SMALL = dict(num_classes=7, vocab_size=19, embed_size=8, hidden_size=8,
             num_res_blocks=2, num_res_block_channels=16, num_input_channels=12,
             num_tail_channels=4, mac_dim=8, mac_max_step=2, max_num_frames=6, max_q_len=9,
             compute_dtype="float32", use_pallas_kernels=True)
LOGIT_ATOL = 1e-4
INT8_LOGIT_ATOL = 2e-3
MODELS = ("lstm", "time_multi_hop", "v_only_cnn2d_lstm", "concat2d", "mac")
# kernel launches of one forward on the kernel route (T = frames served;
# time_multi_hop chains its T passes in one)
LAUNCHES = {"lstm": lambda T: 1, "time_multi_hop": lambda T: 1, "v_only_cnn2d_lstm": lambda T: 1,
            "concat2d": lambda T: 2, "mac": lambda T: 3}
BUCKETS = (2, 4, 6)
MAX_Q_LEN = 56


@pytest.fixture(autouse=True)
def _interpret_pallas(monkeypatch):
    """Route the JAX package's Pallas kernels through interpret mode."""
    for mod_name, name in (("lstm_pallas", "lstm_pallas"),
                           ("int8_matmul_pallas", "matmul_int8_fused_pallas")):
        mod = importlib.import_module(f"videonavqa_tpu.kernels.{mod_name}")
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name), interpret=True))


@functools.lru_cache(maxsize=None)
def _setup(model, extra_items=()):
    """JAX config, spec, weights, and the same weights bridged into the port."""
    extra = dict(extra_items)
    jcfg = JaxConfig(model=model, **{**SMALL, **extra})
    jspec = jax_get_model(model)
    jp, js = jax.jit(jspec.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    flat = flatten_tree(jp, "params/")
    flat.update(flatten_tree(js, "state/"))
    params, state = params_from_jax(flat)
    return jcfg, jspec, jp, js, ModelConfig(model=model, **{**SMALL, **extra}), params, state


def _jax_apply(jspec, jcfg, jp, js, batch, rng=1):
    """Traced anew in each test, under that test's interpret patch."""
    fn = jax.jit(lambda p, s, b: jspec.apply(p, s, b, jcfg, train=False,
                                             rng=jax.random.PRNGKey(rng)))
    return fn(jp, js, {k: jnp.asarray(v) for k, v in batch.items()})


def _batch(spec, T, seed=0, B=3):
    r = np.random.default_rng(seed)
    b = {"question": r.integers(1, 19, (B, 9)).astype(np.int32),
         "q_len": np.array([9, 4, 6][:B], np.int32),
         "v_len": np.array([T, 2, 3][:B], np.int32)}
    b["question"][1, 4:] = 0
    b["question"][2, 6:] = 0
    if spec.uses_stem:
        b["v_features"] = np.maximum(r.standard_normal((B, T, 10, 13, 12)), 0).astype(np.float32)
    elif spec.needs_video:
        b["video"] = r.integers(0, 256, (B, T, 160, 208, 3)).astype(np.uint8)
    return b


def _torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_registry_matches_jax_flags():
    for name in MODELS:
        spec, jspec = get_model(name), jax_get_model(name)
        assert ((spec.needs_video, spec.needs_question, spec.uses_stem)
                == (jspec.needs_video, jspec.needs_question, jspec.uses_stem)), name


@pytest.mark.parametrize("T", [6, 4])  # 6: full frame axis; 4: bucket-trimmed
@pytest.mark.parametrize("model", [m for m in MODELS if m != "lstm"])
def test_logits_match_jax(model, T):
    jcfg, jspec, jp, js, cfg, params, state = _setup(model)
    spec = get_model(model)
    b = _batch(spec, T)
    want, _ = _jax_apply(jspec, jcfg, jp, js, b)
    with torch.inference_mode():
        got, _ = forward(spec, cfg, params, state, _torch(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL)
    with torch.inference_mode():   # the route without the kernel is the same function here
        plain, _ = forward(spec, dataclasses.replace(cfg, use_pallas_kernels=False), params,
                           state, _torch(b))
    np.testing.assert_array_equal(plain.numpy(), got.numpy())


def test_q_only_lstm_matches_jax_from_the_same_initial_state():
    """The JAX model draws (h0, c0) from its rng at eval too; the port's inner
    function takes the JAX-drawn values."""
    jcfg, jspec, jp, js, cfg, params, state = _setup("lstm")
    b = _batch(get_model("lstm"), 6)
    want, _ = _jax_apply(jspec, jcfg, jp, js, b, rng=7)
    k_h, k_c = jax.random.split(jax.random.PRNGKey(7))
    h0, c0 = (torch.from_numpy(np.array(jax.random.normal(k, (3, 8)))) for k in (k_h, k_c))
    got = q_only_lstm.apply_with_state(params, _torch(b), cfg, h0, c0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL)


def test_q_only_lstm_draws_from_the_generator():
    _, _, _, _, cfg, params, state = _setup("lstm")
    spec = get_model("lstm")
    b = _torch(_batch(spec, 6))
    run = lambda seed: forward(spec, cfg, params, state, b,
                               torch.Generator().manual_seed(seed))[0].numpy()
    np.testing.assert_array_equal(run(3), run(3))
    assert np.abs(run(3) - run(4)).max() > 1e-3
    gen = torch.Generator().manual_seed(3)
    h0, c0 = torch.randn((3, 8), generator=gen), torch.randn((3, 8), generator=gen)
    np.testing.assert_array_equal(
        run(3), q_only_lstm.apply_with_state(params, b, cfg, h0, c0).numpy())


def test_time_multi_hop_word_softmax_runs_to_the_batch_max():
    """The -inf mask starts at the batch's max q_len: a longer real question
    moves a short row's logits; a padding row (q_len 1) moves nothing."""
    _, _, _, _, cfg, params, state = _setup("time_multi_hop")
    spec = get_model("time_multi_hop")
    b = _batch(spec, 4)
    with torch.inference_mode():
        full, _ = forward(spec, cfg, params, state, _torch(b))
        short = {k: v[1:] for k, v in b.items()}          # batch max q_len 6, not 9
        alone, _ = forward(spec, cfg, params, state, _torch(short))
        short["q_len"] = np.array([4, 6, 1], np.int32)    # a padding row joins
        for k in ("question", "v_len", "v_features"):
            short[k] = np.concatenate([b[k][1:], b[k][1:2]])
        short["question"][2, 1:] = 0
        padded, _ = forward(spec, cfg, params, state, _torch(short))
    assert np.abs(full[1:].numpy() - alone.numpy()).max() > 1e-6
    np.testing.assert_allclose(padded[:2].numpy(), alone.numpy(), atol=1e-6)


def test_time_multi_hop_int8_trunk_matches_jax():
    extra = (("use_int8_trunk", True),)
    jcfg, jspec, jp, js, cfg, params, _ = _setup("time_multi_hop", extra)
    spec = get_model("time_multi_hop")
    cal, b = _batch(spec, 6, seed=1), _batch(spec, 4, seed=2)
    _, jstate = _jax_apply(jspec, dataclasses.replace(jcfg, int8_trunk_calibrate=True),
                           jp, js, cal)
    want, _ = _jax_apply(jspec, jcfg, jp, jstate, b)
    with torch.inference_mode():
        _, state = forward(spec, dataclasses.replace(cfg, int8_trunk_calibrate=True), params,
                           params_from_jax(flatten_tree(js, "state/"))[1], _torch(cal))
        got, _ = forward(spec, cfg, params, state, _torch(b))
    for name, s in jstate["trunk"]["int8_scales"].items():
        np.testing.assert_allclose(float(state["trunk"]["int8_scales"][name]), float(s),
                                   rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=INT8_LOGIT_ATOL)
    np.testing.assert_array_equal(got.numpy().argmax(-1), np.asarray(want).argmax(-1))


@pytest.mark.parametrize("model", MODELS)
def test_kernel_route_reaches_the_wrapper(model, monkeypatch):
    """With use_pallas_kernels every LSTM pass of the forward goes through the
    chained kernel's wrapper (which, on the CPU, runs the plain version; the
    single-pass ``lstm`` calls it with one pass), the stated number of times;
    without it, none does."""
    _, _, _, _, cfg, params, state = _setup(model)
    spec = get_model(model)
    calls = []
    real = lstm_mod.lstm_frames
    monkeypatch.setattr(lstm_mod, "lstm_frames", lambda *a: calls.append(a[0].shape) or real(*a))
    b = _torch(_batch(spec, 4))
    with torch.inference_mode():
        forward(spec, cfg, params, state, b)
        assert len(calls) == LAUNCHES[model](4)
        forward(spec, dataclasses.replace(cfg, use_pallas_kernels=False), params, state, b)
        assert len(calls) == LAUNCHES[model](4)


def _padded(spec, items, B):
    """The JAX daemon's padding of one micro-batch (cli/serve.py dispatch_batch)."""
    v_len = np.ones(B, np.int32)
    q_len = np.ones(B, np.int32)
    question = np.zeros((B, MAX_Q_LEN), np.int32)
    for i, (_, v, tok) in enumerate(items):
        question[i, :len(tok)] = tok
        v_len[i] = max(v, 1)
        q_len[i] = max(len(tok), 1)
    batch = {"question": question, "v_len": v_len, "q_len": q_len}
    if spec.needs_video:
        t_b = min(t for t in BUCKETS if t >= v_len[:len(items)].max())
        first = items[0][0]
        visual = np.zeros((B, t_b, *first.shape[1:]), first.dtype)
        for i, (f, _, _) in enumerate(items):
            visual[i] = f[:t_b]
        if spec.uses_stem:
            batch["v_features"] = visual
        else:   # the daemon hands the model the uint8 frames already divided by 255
            batch["video"] = visual.astype(np.float32) / 255.0
    return batch


def _engine(model, tmp_path, B):
    from videonavqa_tpu.utils.checkpoint import save_checkpoint

    jcfg, jspec, jp, js, cfg, _, _ = _setup(model)
    save_checkpoint(str(tmp_path / "w.npz"), params=jp, state=js, meta={})
    eng = InferenceEngine(cfg, checkpoint_path=str(tmp_path / "w.npz"), seed=5, max_batch=B,
                          frame_buckets=BUCKETS, device="cpu")
    return eng, jcfg, jspec, jp, js


@pytest.mark.parametrize("model", ["concat2d", "v_only_cnn2d_lstm", "mac"])
def test_engine_serves_video_and_feature_models(model, tmp_path):
    eng, jcfg, jspec, jp, js = _engine(model, tmp_path, 3)
    r = np.random.default_rng(3)
    items = []
    for v in (3, 1):
        visual = (np.maximum(r.standard_normal((6, 10, 13, 12)), 0).astype(np.float32)
                  if eng.spec.uses_stem else
                  r.integers(0, 256, (6, 160, 208, 3)).astype(np.uint8))
        items.append((visual, v, r.integers(1, 19, r.integers(1, 10)).tolist()))
    batch = eng.make_batch(items)
    assert eng.visual_key in batch and batch[eng.visual_key].shape[:2] == (3, 4)
    if not eng.spec.uses_stem:
        assert batch["video"].dtype == torch.uint8 and "v_features" not in batch
    got = eng.run_batch(items)
    logits, _ = _jax_apply(jspec, jcfg, jp, js, _padded(eng.spec, items, 3))
    want = np.asarray(jax.nn.softmax(logits, axis=-1))[:2]
    assert got.shape == (2, 7)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_engine_serves_a_question_only_model(tmp_path):
    """Items carry no frames; (h0, c0) come from the engine's generator, reset
    to the engine's seed for every batch, so a repeated request gets the same
    answer, as the JAX daemon's PRNGKey(0) gives it."""
    eng, _, _, _, _ = _engine("lstm", tmp_path, 3)
    r = np.random.default_rng(4)
    items = [(None, 0, r.integers(1, 19, n).tolist()) for n in (5, 9)]
    batch = eng.make_batch(items)
    assert set(batch) == {"question", "v_len", "q_len"}
    got = eng.run_batch(items)
    gen = torch.Generator().manual_seed(5)
    h0, c0 = torch.randn((3, 8), generator=gen), torch.randn((3, 8), generator=gen)
    want = torch.softmax(q_only_lstm.apply_with_state(eng.params, batch, eng.cfg, h0, c0), -1)
    np.testing.assert_allclose(got, want[:2].numpy(), atol=1e-6)
    np.testing.assert_array_equal(eng.run_batch(items), got)


@pytest.mark.parametrize("seed", [0, 1])
def test_time_multi_hop_bf16_matches_jax(seed, monkeypatch):
    """time_multi_hop in bf16 (the module note gives the bounds): the bf16
    features its output layer takes, caught on both sides, and the logits."""
    extra = (("compute_dtype", "bfloat16"), ("use_pallas_kernels", False))
    jcfg, jspec, jp, js, cfg, params, state = _setup("time_multi_hop", extra)
    seen = {}

    def spy(mod, key):
        inner = mod.linear_chw

        def capture(p, x):
            seen[key] = x
            return inner(p, x)
        monkeypatch.setattr(mod, "linear_chw", capture)

    spy(jax_tmh, "jax")
    spy(tmh_mod, "port")
    b = _batch(get_model("time_multi_hop"), (6, 4)[seed], seed=seed)
    want, _ = jspec.apply(jp, js, {k: jnp.asarray(v) for k, v in b.items()}, jcfg, train=False,
                          rng=jax.random.PRNGKey(1))
    with torch.inference_mode():
        got, _ = forward(get_model("time_multi_hop"), cfg, params, state, _torch(b))
    tail, want_tail = seen["port"].float().numpy(), np.asarray(seen["jax"].astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want_tail).max())) - 7)
    np.testing.assert_allclose(tail, want_tail, rtol=0, atol=ulp)
    assert float((tail == want_tail).mean()) >= 0.99
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert seen["port"].dtype == torch.bfloat16 and seen["jax"].dtype == jnp.bfloat16
