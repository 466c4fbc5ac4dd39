"""The JAX package's block-1 relayouts of the VGG stem (space-to-depth of
conv1_1 or of all of block 1, width-to-depth of block 1) in the port, on the
CPU: the re-laid kernels equal JAX's (OIHW against HWIO), and each variant's
f32 output is held to JAX's and to the port's plain ``vgg_partial`` at rtol
2e-5, atol 2e-6 (F32_TOL: the same products plus structural zeros, summed in
another order), at 2 frames of 32x48 with non-zero biases."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_stem import _conv

from videonavqa_tpu.stem import vgg as jvgg
from videonavqa_tpu_torch.stem import vgg
from videonavqa_tpu_torch.utils.checkpoint import stem_from_jax

F32_TOL = dict(rtol=2e-5, atol=2e-6)   # measured: at most 4.8e-7 absolute
VARIANTS = {
    "s2d_conv1_1": ("relay_s2d_conv1_1", "vgg_partial_s2d"),
    "s2d_block1": ("relay_s2d_block1", "vgg_partial_s2d_block1"),
    "w2d_block1": ("relay_w2d_block1", "vgg_partial_w2d_block1"),
}


@pytest.fixture(scope="module")
def weights():
    r = np.random.default_rng(51)
    w = {"conv1_1": _conv(r, 3, 64, 0.1), "conv1_2": _conv(r, 64, 64, 0.1),
         "conv2_1": _conv(r, 64, 128, 0.1), "conv2_2": _conv(r, 128, 128, 0.1)}
    x = r.random((2, 32, 48, 3), dtype=np.float32)
    return w, stem_from_jax(w, {}, {}, torch.device("cpu"))[0], x


def _leaves(tree):
    return {k: v for k, v in (tree.items() if "weight" not in tree else [("", tree)])}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_relaid_kernels_match_jax(weights, variant):
    jw, tw, _ = weights
    relay = VARIANTS[variant][0]
    want = getattr(jvgg, relay)(jax.tree.map(jnp.asarray, jw))
    got = getattr(vgg, relay)(tw)
    want, got = _leaves(want), _leaves(got)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k]["weight"].permute(2, 3, 1, 0).numpy(),
                                      np.asarray(want[k]["weight"]))
        np.testing.assert_array_equal(got[k]["bias"].numpy(), np.asarray(want[k]["bias"]))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_relaid_vgg_matches_jax_and_the_plain_stem(weights, variant):
    jw, tw, x = weights
    relay, fn = VARIANTS[variant]
    jparams = jax.tree.map(jnp.asarray, jw)
    want = np.asarray(getattr(jvgg, fn)(getattr(jvgg, relay)(jparams), jparams,
                                        jnp.asarray(x), dtype=jnp.float32))
    with torch.no_grad():
        got = getattr(vgg, fn)(getattr(vgg, relay)(tw), tw, torch.from_numpy(x),
                               dtype=torch.float32).numpy()
        plain = vgg.vgg_partial(tw, torch.from_numpy(x), dtype=torch.float32).numpy()
    assert got.shape == want.shape == (2, 8, 12, 128)
    np.testing.assert_allclose(got, want, **F32_TOL)
    np.testing.assert_allclose(got, plain, **F32_TOL)
