"""The port's CQT chain against the JAX package's, on the CPU: the direct
``cqt`` (signal/cqt.py, one float32 matrix product), the host oracle
``multirate_cqt`` (signal/cqt_multirate.py, float64 numpy), and
``rainbowgram`` / ``plotcqt`` (analysis/rainbow.py).

Tolerances: ``cqt`` sums 16384 float32 products per output in another order
than XLA: 1e-5 of the largest output (``RTOL``). The host oracle is the same
numpy code: equal bit for bit. The direct CQT against the oracle: the bound
of tests/test_cqt_fidelity.py, 3% of each interior frame's peak at most and
0.3% on average. Rainbowgram magnitudes are dB features: 1e-4 of their [0, 1]
range; phase derivatives only where the pixel is visible (mag > 0.5; the
angle of a vanishing bin is free), where an angle on +-pi may land on either
side in the two packages (a difference of 2) on at most 1e-3 of them.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_helpers  # noqa: F401  (two torch threads)

from audio_style_transfer_tpu.analysis import rainbow as jrb
from audio_style_transfer_tpu.signal import cqt as jcqt
from audio_style_transfer_tpu.signal import cqt_multirate as jmr
from audio_style_transfer_tpu_torch.analysis import rainbow as trb
from audio_style_transfer_tpu_torch.signal import cqt as tcqt
from audio_style_transfer_tpu_torch.signal import cqt_multirate as tmr

RTOL = 1e-5


def _clip(seconds=1.0, seed=0):
    sr = 16000
    t = np.arange(int(seconds * sr)) / sr
    rng = np.random.RandomState(seed)
    x = sum(0.5 / (h + 1) * np.sin(2 * np.pi * 220.0 * (h + 1) * t) for h in range(5))
    return (x + 0.05 * rng.randn(len(t))).astype(np.float32)


def test_kernel_bank_is_jax_s():
    got = tcqt._cqt_kernels(16000, 240, 40, 0.8, tcqt.C2_HZ)
    want = jcqt._cqt_kernels(16000, 240, 40, 0.8, jcqt.C2_HZ)
    assert got[2] == want[2] == 16384 and tcqt.C2_HZ == jcqt.C2_HZ
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("n", [16000, 12345])
def test_cqt_matches_jax(n):
    x = _clip(n / 16000)
    want = np.asarray(jcqt.cqt(jnp.asarray(x)))
    got = tcqt.cqt(torch.tensor(x))
    assert got.shape == want.shape == (240, 1 + n // 256) and got.dtype == torch.complex64
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= RTOL * scale


def test_cqt_takes_a_batch():
    x = np.stack([_clip(0.5, s) for s in range(2)])
    got = tcqt.cqt(torch.tensor(x))
    for i in range(2):
        want = np.asarray(jcqt.cqt(jnp.asarray(x[i])))
        assert np.abs(got[i].numpy() - want).max() <= RTOL * np.abs(want).max()


def test_multirate_copy_equals_jax_and_bounds_the_direct_cqt():
    x = _clip()
    oracle = tmr.multirate_cqt(x)
    np.testing.assert_array_equal(oracle, jmr.multirate_cqt(x))
    m_dev = np.abs(tcqt.cqt(torch.tensor(x)).numpy())[:, 8:-8]
    m_orc = np.abs(oracle)[:, 8:-8]
    dev = np.abs(m_dev - m_orc) / np.maximum(m_orc.max(axis=0, keepdims=True), 1e-12)
    assert dev.max() < 0.03 and dev.mean() < 0.003, (dev.max(), dev.mean())


@pytest.mark.parametrize("backend", ["device", "multirate"])
def test_rainbowgram_matches_jax(backend):
    x = _clip(0.5, seed=1)
    mag_j, p_j = jrb.rainbowgram(x, backend=backend)
    mag_t, p_t = trb.rainbowgram(x, backend=backend, device="cpu")
    assert mag_t.shape == p_t.shape == (240, 1 + len(x) // 256)
    assert np.abs(mag_t - np.asarray(mag_j)).max() <= 1e-4
    vis = np.asarray(mag_j) > 0.5
    d = np.abs(p_t - np.asarray(p_j))[vis]
    off = d > 1e-3
    assert off.mean() <= 1e-3, off.mean()
    assert np.all(np.abs(d[off] - 2.0) <= 1e-3)


def test_rainbowgram_override_and_bad_backend():
    x = _clip(0.5, seed=2)
    c = tmr.multirate_cqt(x)
    mag, p = trb.rainbowgram(x, cqt_override=c)
    mag_m, p_m = trb.rainbowgram(x)
    assert np.abs(mag - mag_m).max() <= 1e-6
    with pytest.raises(ValueError, match="backend"):
        trb.rainbowgram(x, backend="librosa")


def test_plotcqt_writes_the_figure_jax_does(tmp_path):
    from audio_style_transfer_tpu_torch.utils.audio_io import write_wav

    path = str(tmp_path / "tone.wav")
    write_wav(path, 0.3 * _clip(0.5, seed=3), 16000)
    out = str(tmp_path / "cqt.png")
    mag, p = trb.plotcqt(path, savepath=out)
    assert os.path.getsize(out) > 0
    mag_j, p_j = jrb.plotcqt(path)
    assert np.abs(mag - np.asarray(mag_j)).max() <= 1e-4
