"""STFT of the transfer regularizer (counterpart of
audio_style_transfer_tpu/signal/stft.py: ``_hann``, ``frame_signal``,
``stft``, ``stft_l1``).

The reference's regularizer (methods.py:122-123) uses
``tf.contrib.signal.stft(frame_length=1024, frame_step=512)``: periodic Hann
window, no centring, rFFT over the last frame axis. ``torch.fft.rfft`` does
the transform, as ``jnp.fft.rfft`` does in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from audio_style_transfer_tpu_torch.signal.mu_law import safe_abs


def _hann(frame_length: int, periodic: bool = True) -> np.ndarray:
    n = frame_length if periodic else frame_length - 1
    k = np.arange(frame_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)).astype(np.float32)


def frame_signal(x: torch.Tensor, frame_length: int, frame_step: int) -> torch.Tensor:
    """Slice ``x`` [..., T] into frames [..., n_frames, frame_length], with
    ``n_frames = 1 + (T - frame_length) // frame_step`` (tf.contrib.signal.frame,
    pad_end=False)."""
    n_frames = 1 + (x.shape[-1] - frame_length) // frame_step
    return x.unfold(-1, frame_length, frame_step)[..., :n_frames, :]


def stft(x: torch.Tensor, frame_length: int = 1024, frame_step: int = 512, *,
         window=None) -> torch.Tensor:
    """Non-centred STFT matching tf.contrib.signal.stft (methods.py:122):
    complex [..., n_frames, frame_length // 2 + 1] of a [..., T] signal.
    ``window`` defaults to the periodic Hann window."""
    if window is None:
        window = _hann(frame_length, periodic=True)
    window = torch.as_tensor(window, dtype=x.dtype, device=x.device)
    frames = frame_signal(x, frame_length, frame_step) * window
    return torch.fft.rfft(frames, n=frame_length, dim=-1)


def stft_l1(x: torch.Tensor, frame_length: int = 1024, frame_step: int = 512) -> torch.Tensor:
    """The transfer regularizer: mean(|Re STFT| + |Im STFT|), with the
    gradient-safe abs (reference utils.py:92-93)."""
    s = stft(x, frame_length, frame_step)
    return torch.mean(safe_abs(s.real) + safe_abs(s.imag))
