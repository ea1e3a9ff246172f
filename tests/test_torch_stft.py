"""The port's STFT regularizer (signal/stft.py) and the gamma != 0 loss vs
the JAX package, float32 on the CPU.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import TOY, jax_params_np, n, t, torch_params

from audio_style_transfer_tpu.models.wavenet_ae import WaveNetAEConfig as JCfg
from audio_style_transfer_tpu.signal.mu_law import mu_law_numpy
from audio_style_transfer_tpu.transfer import losses as jlosses
from audio_style_transfer_tpu_torch.models.wavenet_ae import WaveNetAEConfig as TCfg
from audio_style_transfer_tpu_torch.transfer import losses as tlosses

# The modules, not the functions of the same name the packages re-export.
jstft = importlib.import_module("audio_style_transfer_tpu.signal.stft")
tstft = importlib.import_module("audio_style_transfer_tpu_torch.signal.stft")

# Both sides run a float32 FFT of 1024 points on the same frames; the two
# libraries order the butterflies differently (about 1e-6 of the peak).
RTOL = 1e-5


def _signal(t_len=4096, seed=0):
    rng = np.random.RandomState(seed)
    return (0.3 * np.sin(np.arange(t_len) * 0.05) + 0.05 * rng.randn(t_len)).astype(np.float32)


def test_hann_window_is_the_periodic_one():
    np.testing.assert_array_equal(tstft._hann(1024), jstft._hann(1024))
    np.testing.assert_array_equal(tstft._hann(16, periodic=False), jstft._hann(16, periodic=False))


@pytest.mark.parametrize("t_len,fl,fs", [(4096, 1024, 512), (5000, 1024, 512), (300, 64, 16)])
def test_frames_match_jax(t_len, fl, fs):
    x = np.stack([_signal(t_len), _signal(t_len, 1)])
    got = tstft.frame_signal(t(x), fl, fs)
    want = jstft.frame_signal(jnp.asarray(x), fl, fs)
    assert got.shape == want.shape == (2, 1 + (t_len - fl) // fs, fl)
    np.testing.assert_array_equal(n(got), n(want))


@pytest.mark.parametrize("t_len", [4096, 5000])
def test_stft_matches_jax(t_len):
    x = _signal(t_len)
    got = tstft.stft(t(x))
    want = np.asarray(jstft.stft(jnp.asarray(x)))
    assert got.shape == want.shape and got.dtype == torch.complex64
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL * scale)


def test_stft_l1_value_and_gradient_match_jax():
    x = _signal()
    fj, gj = jax.value_and_grad(jstft.stft_l1)(jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    ft = tstft.stft_l1(xt)
    (gt,) = torch.autograd.grad(ft, xt)
    np.testing.assert_allclose(float(ft.detach()), float(fj), rtol=RTOL)
    np.testing.assert_allclose(n(gt), n(gj), rtol=RTOL, atol=RTOL * float(np.abs(gj).max()))


def test_stft_l1_gradient_is_finite_at_zero():
    xt = torch.zeros(2048, requires_grad=True)
    (g,) = torch.autograd.grad(tstft.stft_l1(xt), xt)
    assert bool(torch.isfinite(g).all())


@pytest.mark.parametrize("gamma", [1e-3, 1.0])
def test_loss_with_the_regularizer_matches_jax(gamma):
    """The gamma != 0 branch at the toy geometry: every component and the
    waveform gradient, at the slice tests' tolerance (1e-5)."""
    pnp = jax_params_np(**TOY)
    jp, tp = jax.tree.map(jnp.asarray, pnp), torch_params(pnp)
    kw = dict(cont_lyr_ids=(3,), style_layer_ids=(0, 1, 2), gamma=gamma)
    spec_j, spec_t = jlosses.LossSpec(**kw), tlosses.LossSpec(**kw)
    xq = mu_law_numpy(_signal())[None].astype(np.float32)
    other = mu_law_numpy(0.2 * np.random.RandomState(1).randn(1, 4096)).astype(np.float32)
    phi_c, phi_s = jlosses.transfer_embeds(jp, jnp.asarray(other), JCfg(**TOY), spec_j)

    def jloss(x):
        return jlosses.transfer_loss(jp, x[None], phi_c, phi_s, JCfg(**TOY), spec_j)

    (fj, pj), gj = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jnp.asarray(xq[0]))
    xt = t(xq[0]).requires_grad_(True)
    ft, pt = tlosses.transfer_loss(tp, xt[None], t(phi_c), t(phi_s), TCfg(**TOY), spec_t)
    (gt,) = torch.autograd.grad(ft, xt)
    assert float(pt["regularizer"].detach()) > 0
    for k in ("loss", "content_loss", "style_loss", "regularizer"):
        np.testing.assert_allclose(n(pt[k]), n(pj[k]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(gt), n(gj), rtol=1e-5, atol=1e-5 * float(np.abs(gj).max()))
    # gamma = 0 builds no regularizer.
    _, p0 = tlosses.transfer_loss(tp, t(xq), t(phi_c), t(phi_s), TCfg(**TOY),
                                  dataclasses.replace(spec_t, gamma=0.0))
    assert float(p0["regularizer"]) == 0.0
