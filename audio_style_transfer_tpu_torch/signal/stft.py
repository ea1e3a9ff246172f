"""STFTs (counterpart of audio_style_transfer_tpu/signal/stft.py).

Two consumers in the reference define the semantics:

* the transfer regularizer (reference methods.py:122-123) uses
  ``tf.contrib.signal.stft(frame_length=1024, frame_step=512)``: periodic
  Hann window, no centring, rFFT over the last frame axis (``stft``,
  ``stft_l1``);
* the librosa-style centred STFT and its inverse (reference
  nsynth/utils.py:206-272), which the baseline spectral AE's specgram
  features use (``centered_stft``, ``istft``).

``torch.fft.rfft`` / ``irfft`` do the transforms, as ``jnp.fft`` does in the
JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

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


def _centered_stft_512(x: torch.Tensor) -> torch.Tensor:
    """``centered_stft`` at n_fft 512, hop 256, over any leading dims."""
    return centered_stft(x, n_fft=512, hop_length=256)


def centered_stft(x: torch.Tensor, n_fft: int = 512, hop_length: int | None = None, *,
                  window=None) -> torch.Tensor:
    """librosa-compatible centred STFT (librosa.stft(center=True,
    win_length=n_fft), reference nsynth/utils.py:233-236): reflect-pad n_fft//2
    on both sides, periodic Hann window. Returns complex [..., 1 + n_fft//2,
    n_frames] (librosa's [freq, time] layout) of a [..., T] signal."""
    if hop_length is None:
        hop_length = n_fft // 2
    if window is None:
        window = _hann(n_fft, periodic=True)
    window = torch.as_tensor(window, dtype=x.dtype, device=x.device)
    pad = n_fft // 2
    # F.pad's reflect mode pads the last dim of a [N, C, W] tensor only.
    lead = x.shape[:-1]
    x = F.pad(x.reshape(1, -1, x.shape[-1]), (pad, pad), mode="reflect")
    x = x.reshape(*lead, x.shape[-1])
    frames = frame_signal(x, n_fft, hop_length) * window
    return torch.fft.rfft(frames, n=n_fft, dim=-1).transpose(-1, -2)


def istft(spec: torch.Tensor, n_fft: int = 512, hop_length: int | None = None, *,
          length: int | None = None) -> torch.Tensor:
    """Inverse of :func:`centered_stft` by windowed overlap-add
    (librosa.istft(center=True): Hann synthesis window, squared-window
    normalisation). ``spec`` is complex [..., freq, time]; returns [..., T].

    The overlap-add is ``F.fold``, whose output element sums its frames in a
    fixed order (no atomics, so the card gives the same bits every run); the
    squared-window normaliser is computed once on the host, as JAX does."""
    if hop_length is None:
        hop_length = n_fft // 2
    window_np = _hann(n_fft, periodic=True)
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1)
    frames = frames * torch.as_tensor(window_np, dtype=frames.dtype, device=frames.device)

    n_frames = frames.shape[-2]
    total = n_fft + hop_length * (n_frames - 1)
    batch_shape = frames.shape[:-2]
    flat = frames.reshape(-1, n_frames, n_fft).transpose(1, 2)  # [B, n_fft, n_frames]
    out = F.fold(flat, output_size=(1, total), kernel_size=(1, n_fft),
                 stride=(1, hop_length)).reshape(-1, total)

    idx = (np.arange(n_frames)[:, None] * hop_length + np.arange(n_fft)[None, :]).reshape(-1)
    wsq = np.zeros(total, np.float32)
    np.add.at(wsq, idx, np.tile(window_np**2, n_frames))
    out = out / torch.as_tensor(np.maximum(wsq, np.float32(1e-10)), device=out.device)

    pad = n_fft // 2
    out = out[:, pad : total - pad]
    if length is not None:
        out = out[:, :length]
    return out.reshape(*batch_shape, out.shape[-1])
