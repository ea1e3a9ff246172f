"""Constant-Q transform as one matrix product (counterpart of
audio_style_transfer_tpu/signal/cqt.py).

Replaces the librosa.cqt call of the reference rainbowgram (reference
rainbowgram.py:49-53: hop 256, 40 bins/octave, 240 bins, filter_scale 0.8,
fmin C2). librosa evaluates the CQT by recursive octave down-sampling on the
host; on a device the direct definition is better: the complex Morlet bank,
built once on the host, is a dense [L, 2 * n_bins] real matrix (the real
parts beside the imaginary ones; [16384, 480] at the defaults), and every
bin of every frame is one float32 ``torch.matmul`` of the frames by it
(JAX: two ``jnp.dot``, outside any Pallas kernel).

Numerics: this is the direct CQT (what librosa's multirate scheme
approximates), so values agree with librosa to plotting accuracy, not bit
for bit (tests/test_cqt_fidelity.py bounds it; signal/cqt_multirate.py is
the host oracle).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from audio_style_transfer_tpu_torch.signal.stft import frame_signal

C2_HZ = 65.40639132514966  # librosa.note_to_hz('C2')


@functools.lru_cache(maxsize=8)
def _cqt_kernels(
    sr: int,
    n_bins: int,
    bins_per_octave: int,
    filter_scale: float,
    fmin: float,
):
    """Hann-windowed complex exponential bank, centred in a common length L.

    Returns (kernels_real, kernels_imag) each [L, n_bins] float32, plus L.
    Kernels are L1-normalised, then scaled by sqrt(their length) to match
    librosa's scale=True convention (response / sqrt(filter length)).
    """
    q = filter_scale / (2.0 ** (1.0 / bins_per_octave) - 1.0)
    freqs = fmin * 2.0 ** (np.arange(n_bins) / bins_per_octave)
    lengths = np.ceil(q * sr / freqs).astype(int)
    max_len = int(lengths.max())
    # Round up to an even FFT/window-friendly length.
    L = int(2 ** np.ceil(np.log2(max_len)))

    bank = np.zeros((L, n_bins), dtype=np.complex64)
    for k, (f, n) in enumerate(zip(freqs, lengths)):
        t = np.arange(n) - (n - 1) / 2.0
        win = np.hanning(n)
        kern = win * np.exp(2.0j * np.pi * f * t / sr)
        kern /= np.abs(kern).sum()  # L1 normalization (librosa util.normalize)
        start = (L - n) // 2
        # librosa scale=True divides the response by sqrt(filter length).
        bank[start : start + n, k] = kern * np.sqrt(n)
    return (
        np.ascontiguousarray(bank.real.astype(np.float32)),
        np.ascontiguousarray(bank.imag.astype(np.float32)),
        L,
    )


@functools.lru_cache(maxsize=8)
def _device_bank(sr: int, n_bins: int, bins_per_octave: int, filter_scale: float,
                 fmin: float, device: str) -> torch.Tensor:
    """[L, 2 * n_bins]: the real kernels beside the imaginary ones, on
    ``device``, made once per geometry and device."""
    kr, ki, _ = _cqt_kernels(sr, n_bins, bins_per_octave, filter_scale, fmin)
    return torch.from_numpy(np.concatenate([kr, ki], axis=1)).to(device)


def cqt(
    audio: torch.Tensor,
    sr: int = 16000,
    hop_length: int = 256,
    bins_per_octave: int = 40,
    n_bins: int = 240,
    filter_scale: float = 0.8,
    fmin: float = C2_HZ,
) -> torch.Tensor:
    """Direct constant-Q transform of ``audio`` [..., T] on its device:
    complex [..., n_bins, n_frames], n_frames = 1 + T // hop_length (librosa's
    centred framing, zero padding at the clip's edges)."""
    bank = _device_bank(sr, n_bins, bins_per_octave, filter_scale, float(fmin),
                        str(audio.device))
    L = bank.shape[0]
    pad = L // 2
    n_frames = 1 + audio.shape[-1] // hop_length
    x = F.pad(audio, (pad, pad + hop_length))
    frames = frame_signal(x, L, hop_length)[..., :n_frames, :]
    out = torch.matmul(frames, bank)
    return torch.complex(out[..., :n_bins], out[..., n_bins:]).transpose(-1, -2)
