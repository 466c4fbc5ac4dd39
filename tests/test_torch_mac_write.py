"""MAC's write-unit variants (self-attention over the earlier steps, the memory
gate) in the port against the JAX package, on the CPU, at the small widths of
tests/test_torch_train.py (mac_dim 8, 3 steps). Both packages' module
constants are switched on at run time (monkeypatch; the JAX package is not
edited), each variant alone and both together.

Bounds: the eval logits atol 1e-5 (LOGIT_ATOL); the 3-step train golden
(mean CE, clip 1.0, the +-1 element clamp, no dropout, Adam 1e-3) to the
bounds of tests/test_torch_train_zoo.py: each loss and step 1's grad_norm
rtol 1e-5, every parameter GOLDEN_ATOL and every element GOLDEN_TIGHT_ATOL
but those of the noise leaves and those whose clipped gradient lay under
Adam's eps. Measured values stand beside each bound.
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_train import (
    GOLDEN_ATOL, GOLDEN_TIGHT_ATOL, SMALL, _batch, _bridge, _j, _max_diff, _port_tree_as_jax, _t)
from test_torch_train_zoo import ADAM_EPS, NOISE_LEAVES

from videonavqa_tpu.models import ModelConfig as JaxConfig
from videonavqa_tpu.models import get_model as jax_get_model
from videonavqa_tpu.models import mac as jmac
from videonavqa_tpu.train import step as jstep
from videonavqa_tpu_torch.cli.common import TRAIN_STEP_OPTIONS
from videonavqa_tpu_torch.models import ModelConfig, get_model
from videonavqa_tpu_torch.models import mac as mac_mod
from videonavqa_tpu_torch.train import step

LOGIT_ATOL = 1e-5   # measured: at most 8.9e-8 (both variants)
VARIANTS = {"self_attention": (True, False), "memory_gate": (False, True),
            "both": (True, True)}
# write_attn's bias shifts every earlier step's logit alike and cancels in the
# softmax, as the noise leaves of test_torch_train_zoo.py do.
WRITE_NOISE_LEAVES = ("mac/write_attn/bias",)


@pytest.fixture(params=list(VARIANTS))
def variant(request, monkeypatch):
    sa, mg = VARIANTS[request.param]
    for mod in (jmac, mac_mod):
        monkeypatch.setattr(mod, "SELF_ATTENTION", sa)
        monkeypatch.setattr(mod, "MEMORY_GATE", mg)
    return sa, mg


def _setup():
    """(JAX config, JAX params and state, port config, port params and state).
    JAX's init runs unjitted: a jitted init may be a cached trace made with
    the constants off."""
    fields = {**SMALL, "model": "mac", "mac_dropout": 0.0}
    jcfg = JaxConfig(**fields)
    jp, js = jax_get_model("mac").init(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, js, ModelConfig(**fields), *_bridge(jp, js)


def test_variant_parameters_are_in_both_inits(variant):
    sa, mg = variant
    _, jp, _, cfg, params, _ = _setup()
    want = ({"write_attn", "write_mem"} if sa else set()) | ({"write_control"} if mg else set())
    assert want <= set(jp["mac"]) and want <= set(params["mac"])
    got, _ = get_model("mac").init(torch.Generator().manual_seed(0), cfg, torch.device("cpu"))
    assert {k: v["weight"].shape for k, v in got["mac"].items() if k in want} == \
        {k: tuple(np.shape(jp["mac"][k]["weight"])) for k in want}


def test_eval_logits_match_jax(variant):
    jcfg, jp, js, cfg, params, state = _setup()
    b = _batch(20)
    jspec = jax_get_model("mac")
    want, _ = jax.jit(lambda p, batch: jspec.apply(p, js, batch, jcfg, train=False))(jp, _j(b))
    with torch.no_grad():
        got, _ = get_model("mac").apply(params, state, _t(b), cfg, train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL)


def test_variant_recomputes_no_step(variant, monkeypatch):
    """With a variant on the cell keeps its histories, as JAX's, and takes no
    checkpointed step."""
    _, _, _, cfg, params, state = _setup()

    def refuse(*args, **kwargs):
        raise AssertionError("a variant step was checkpointed")

    monkeypatch.setattr(mac_mod, "checkpoint", refuse)
    for p in step.tree_leaves(params):
        p.requires_grad_(True)
    logits, _ = get_model("mac").apply(params, state, _t(_batch(21)), cfg, train=True)
    logits.sum().backward()
    assert params["mac"]["write_concat"]["weight"].grad is not None


def test_train_step_matches_jax_for_three_steps(variant):
    jcfg, jp, js, cfg, params, state = _setup()
    jopt = jstep.make_optimizer(1e-3)
    jopt_state = jopt.init(jp)
    jtrain = jstep.make_train_step(jax_get_model("mac"), jcfg, jopt, donate=False,
                                   **TRAIN_STEP_OPTIONS["mac"])
    train = step.make_train_step(get_model("mac"), cfg, step.make_optimizer(params, 1e-3),
                                 **TRAIN_STEP_OPTIONS["mac"])
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
        for k, p in step.tree_items(params):
            sub_eps[k] |= p.grad.abs() < ADAM_EPS
    got = _port_tree_as_jax(params)
    assert _max_diff(got, jp) <= GOLDEN_ATOL
    tight = dict(step.tree_items(_port_tree_as_jax(sub_eps)))
    want = dict(step.tree_items(jp))
    for k, v in step.tree_items(got):
        if k not in NOISE_LEAVES["mac"] + WRITE_NOISE_LEAVES:
            d = np.abs(v - np.asarray(want[k]))[~tight[k]]
            assert d.size == 0 or d.max() <= GOLDEN_TIGHT_ATOL, k
