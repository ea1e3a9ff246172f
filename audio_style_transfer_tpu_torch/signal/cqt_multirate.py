"""Multirate (recursive octave down-sampling) CQT, the librosa algorithm,
in float64 numpy on the host (a copy of
audio_style_transfer_tpu/signal/cqt_multirate.py).

The reference rainbowgram calls ``librosa.cqt`` on the HOST (reference
rainbowgram.py:49-53: hop 256, 40 bins/octave, 240 bins, filter_scale 0.8,
fmin C2); librosa evaluates the constant-Q transform by building kernels for
the top octave only, correlating, halving the sample rate, and repeating
(Schoerkhuber & Klapuri 2010). This module implements that algorithm with a
polyphase decimator (scipy.signal.resample_poly, Kaiser-14 window, an
anti-alias filter at least as good as librosa's default), so host
rainbowgram plots come from the transform family the reference renders
from.

The device path is :func:`audio_style_transfer_tpu_torch.signal.cqt.cqt`
(the direct definition as one matrix product), whose deviation from this
algorithm tests/test_cqt_fidelity.py bounds (1.9% of a frame's peak).

Conventions (identical to signal/cqt.py so the two backends are
frame-aligned): frames centered at ``k * hop_length`` with zero padding at
the clip edges; kernels Hann-windowed complex exponentials, L1-normalized
then scaled by sqrt(len) (librosa ``scale=True``); octave d's responses
scaled by sqrt(2**d) so magnitudes match the direct definition (kernel
length doubles per octave down).
"""

from __future__ import annotations

import functools

import numpy as np

from audio_style_transfer_tpu_torch.signal.cqt import C2_HZ


@functools.lru_cache(maxsize=8)
def _top_octave_kernels(sr: int, bins_per_octave: int, n_bins: int,
                        filter_scale: float, fmin: float):
    """One kernel bank serves the whole transform: after d octaves of
    downsampling, bin (top_octave - d, j) sits at the SAME normalized
    frequency as top-octave bin j at the original rate — the crux of the
    multirate algorithm."""
    q = filter_scale / (2.0 ** (1.0 / bins_per_octave) - 1.0)
    top = fmin * 2.0 ** (
        (n_bins - bins_per_octave + np.arange(bins_per_octave))
        / bins_per_octave
    )
    kernels = []
    for f in top:
        n = int(np.ceil(q * sr / f))
        t = np.arange(n) - (n - 1) / 2.0
        k = np.hanning(n) * np.exp(2.0j * np.pi * f * t / sr)
        k /= np.abs(k).sum()  # L1 normalization (librosa util.normalize)
        kernels.append(k * np.sqrt(n))  # librosa scale=True convention
    return tuple(kernels)


def _correlate_at(x: np.ndarray, k: np.ndarray, centers: np.ndarray):
    """y[i] = sum_m x[centers[i] - len(k)//2 + m] * k[m], zeros outside x.

    One FFT convolution per kernel instead of a python loop over frames
    (float64 FFT vs direct dot differ at ~1e-15 relative — far below the
    fidelity tolerances this feeds)."""
    import scipy.signal

    n = len(k)
    conv = scipy.signal.fftconvolve(x.astype(np.complex128), k[::-1],
                                    mode="full")
    idx = centers + (n - 1) - n // 2
    valid = (idx >= 0) & (idx < conv.shape[0])
    out = np.zeros(centers.shape, np.complex128)
    out[valid] = conv[idx[valid]]
    return out


def multirate_cqt(
    audio,
    sr: int = 16000,
    hop_length: int = 256,
    bins_per_octave: int = 40,
    n_bins: int = 240,
    filter_scale: float = 0.8,
    fmin: float = C2_HZ,
) -> np.ndarray:
    """Recursive-downsampling CQT in float64 (host; the librosa algorithm).

    Args:
      audio: [T] float signal.
    Returns:
      Complex128 [n_bins, n_frames] with n_frames = 1 + T // hop_length.
    """
    import scipy.signal

    n_oct = n_bins // bins_per_octave
    if n_oct * bins_per_octave != n_bins:
        raise ValueError(
            f"n_bins {n_bins} must be a multiple of bins_per_octave "
            f"{bins_per_octave}"
        )
    if hop_length % (2 ** (n_oct - 1)):
        raise ValueError(
            f"hop_length {hop_length} must be divisible by "
            f"2**{n_oct - 1} for {n_oct} octaves"
        )
    kernels = _top_octave_kernels(int(sr), int(bins_per_octave), int(n_bins),
                                  float(filter_scale), float(fmin))
    x = np.asarray(audio, np.float64)
    n_frames = 1 + x.shape[-1] // hop_length
    frames = np.arange(n_frames)

    C = np.zeros((n_bins, n_frames), np.complex128)
    hop_o = hop_length
    for d in range(n_oct):  # d octaves down from the top
        lo = n_bins - (d + 1) * bins_per_octave
        centers = frames * hop_o
        for j, k in enumerate(kernels):
            C[lo + j] = _correlate_at(x, k, centers)
        C[lo : lo + bins_per_octave] *= np.sqrt(2.0**d)
        if d != n_oct - 1:
            x = scipy.signal.resample_poly(x, 1, 2, window=("kaiser", 14.0))
            hop_o //= 2
    return C
