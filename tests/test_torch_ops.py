"""Port mu-law codecs, conv1d/pool1d and gram helpers vs the JAX package.

float32 on the CPU; the same arithmetic summed in other orders, so 1e-5.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import n, t

from audio_style_transfer_tpu.ops import conv as jconv
from audio_style_transfer_tpu.transfer import grams as jgrams
from audio_style_transfer_tpu_torch.ops import conv as tconv
from audio_style_transfer_tpu_torch.transfer import grams as tgrams

RTOL = ATOL = 1e-5
# Both signal packages re-export a function named mu_law over the module.
jmu = importlib.import_module("audio_style_transfer_tpu.signal.mu_law")
tmu = importlib.import_module("audio_style_transfer_tpu_torch.signal.mu_law")


def test_mu_law_codecs_match_jax():
    x = np.linspace(-1, 1, 1001).astype(np.float32)
    np.testing.assert_array_equal(tmu.mu_law_numpy(x), jmu.mu_law_numpy(x))
    q = np.arange(-128, 129).astype(np.float32)
    np.testing.assert_allclose(tmu.inv_mu_law_numpy(q), jmu.inv_mu_law_numpy(q), rtol=RTOL)
    np.testing.assert_allclose(n(tmu.mu_law(t(x))), n(jmu.mu_law(jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(n(tmu.inv_mu_law(t(q))), n(jmu.inv_mu_law(jnp.asarray(q))),
                               rtol=RTOL, atol=ATOL)
    # Gradient-safe at 0 and at the -0.5 half-bin kink, as the JAX flavour.
    qt = t(q).requires_grad_(True)
    (gt,) = torch.autograd.grad(tmu.inv_mu_law(qt).sum(), qt)
    gj = jax.grad(lambda v: jnp.sum(jmu.inv_mu_law(v)))(jnp.asarray(q))
    assert np.all(np.isfinite(n(gt)))
    np.testing.assert_allclose(n(gt), n(gj), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("f,cin,d,causal", [
    (3, 4, 1, False), (3, 4, 8, False), (3, 4, 2, True), (1, 4, 1, True),
    (3, 1, 1, False), (3, 1, 4, True),
])
@pytest.mark.parametrize("batch", [1, 2])
def test_conv1d_matches_jax(f, cin, d, causal, batch):
    rng = np.random.RandomState(f * 10 + cin + d)
    x = rng.randn(batch, 64, cin).astype(np.float32)
    w = rng.randn(f, cin, 5).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    got = tconv.conv1d(t(x), t(w), t(b), dilation=d, causal=causal)
    want = jconv.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), dilation=d,
                        causal=causal)
    np.testing.assert_allclose(n(got), n(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("f,d,causal", [(3, 4, True), (3, 2, False), (2, 3, False),
                                         (1, 1, True)])
def test_merged_taps_conv_and_its_gradients_match_jax(f, d, causal):
    """The bf16 CUDA path's arithmetic (one product of the taps side by
    side, each gradient one product), run here in float64 on the CPU: the
    output, dx and dw of JAX's conv1d (float32 values, so 1e-5)."""
    rng = np.random.RandomState(f * 10 + d)
    x = rng.randn(2, 64, 4).astype(np.float32)
    w = rng.randn(f, 4, 5).astype(np.float32)
    g = rng.randn(2, 64, 5).astype(np.float32)
    xt, wt = (torch.from_numpy(a).double().requires_grad_(True) for a in (x, w))
    y = tconv._MergedTapsConv.apply(xt, wt, tconv._offsets(f, d, causal))
    dx, dw = torch.autograd.grad(y, [xt, wt], torch.from_numpy(g).double())
    want, vjp = jax.vjp(lambda a, b: jconv.conv1d(a, b, None, dilation=d, causal=causal),
                        jnp.asarray(x), jnp.asarray(w))
    for got, ref in zip((y, dx, dw), (want, *vjp(jnp.asarray(g)))):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("setting", [True, False])
def test_float32_reduction_restores_the_global_flag(setting):
    """The bf16 products run with reduced-precision split-K off and leave
    the process-wide flag as they found it, also when the product raises."""
    m = torch.backends.cuda.matmul
    before = m.allow_bf16_reduced_precision_reduction
    try:
        m.allow_bf16_reduced_precision_reduction = setting
        with tconv._float32_reduction():
            assert m.allow_bf16_reduced_precision_reduction is False
        assert m.allow_bf16_reduced_precision_reduction is setting
        with pytest.raises(RuntimeError), tconv._float32_reduction():
            raise RuntimeError("a failed product")
        assert m.allow_bf16_reduced_precision_reduction is setting
    finally:
        m.allow_bf16_reduced_precision_reduction = before


def test_pool1d_matches_jax():
    x = np.random.RandomState(0).randn(2, 1024, 3).astype(np.float32)
    for mode in ("avg", "max"):
        np.testing.assert_allclose(n(tconv.pool1d(t(x), 512, mode)),
                                   n(jconv.pool1d(jnp.asarray(x), 512, mode)),
                                   rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError):
        tconv.pool1d(t(x[:, :1000]), 512)


def test_gram_helpers_match_jax():
    rng = np.random.RandomState(1)
    taps = [rng.randn(1, 256, 8).astype(np.float32) for _ in range(4)]
    for gatys in (False, True):
        got = tgrams.style_gram([t(a) for a in taps], [0, 2, 3], gatys=gatys, nb_channels=6)
        want = jgrams.style_gram([jnp.asarray(a) for a in taps], [0, 2, 3], gatys=gatys,
                                 nb_channels=6)
        np.testing.assert_allclose(n(got), n(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        n(tgrams.content_embeds([t(a) for a in taps], (1, 3), 5)),
        n(jgrams.content_embeds([jnp.asarray(a) for a in taps], (1, 3), 5)))
    z = np.zeros((2, 3, 3), np.float32)
    np.testing.assert_array_equal(n(tgrams.l2_normalize(t(z))), n(jgrams.l2_normalize(z)))
    assert tgrams.select_style_layers(30, stack=1) == jgrams.select_style_layers(30, stack=1)
    assert tgrams.select_style_layers(30, None, [1, 5]) == [1, 5]
    assert tgrams.select_style_layers(30, None) == list(range(30))
