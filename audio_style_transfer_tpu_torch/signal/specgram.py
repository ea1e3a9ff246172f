"""Log-magnitude / phase-derivative spectrogram features and Griffin-Lim
(counterpart of audio_style_transfer_tpu/signal/specgram.py; reference
nsynth/utils.py:206-363: ``specgram``, ``ispecgram``, ``griffin_lim``).

The reference ran these on the host through librosa and ``tf.py_func``
(nsynth/utils.py:403-433); here they are torch functions that run on the
device their input lies on.

``specgram`` takes one clip [T], as JAX's does, or a batch [..., T]: the
maxima that normalise it (``power_to_db``'s reference level and top-dB
floor, the linear magnitude's peak) are then taken per clip, as JAX's
pipeline computes them by calling it clip by clip.
"""

from __future__ import annotations

import math

import torch

from audio_style_transfer_tpu_torch.signal.stft import centered_stft, istft


def _amax(x: torch.Tensor, dims) -> torch.Tensor:
    """The max over ``dims`` (all of x when None), kept for broadcasting."""
    if dims is None:
        return x.max()
    return x.amax(dim=dims, keepdim=True)


def power_to_db(power: torch.Tensor, amin: float = 1e-13, top_db: float = 120.0,
                dims=None) -> torch.Tensor:
    """librosa.power_to_db(ref=np.max): the reference level and the top_db
    floor from the max over ``dims`` (default: the whole input, as JAX)."""
    log_spec = 10.0 * torch.log10(torch.clamp(power, min=amin))
    log_spec = log_spec - 10.0 * torch.log10(torch.clamp(_amax(power, dims), min=amin))
    return torch.maximum(log_spec, _amax(log_spec, dims) - top_db)


def unwrap(p: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """np.unwrap (period 2 pi) along ``dim``, with numpy's tie rule: a jump of
    exactly pi upward stays +pi. ``torch.remainder`` floors like ``jnp.mod``."""
    dd = torch.diff(p, dim=dim)
    ddmod = torch.remainder(dd + math.pi, 2.0 * math.pi) - math.pi
    ddmod = torch.where((ddmod == -math.pi) & (dd > 0), torch.full_like(ddmod, math.pi), ddmod)
    corr = torch.where(dd.abs() < math.pi, torch.zeros_like(dd), ddmod - dd)
    cum = torch.cumsum(corr, dim=dim)
    return p + torch.cat([torch.zeros_like(cum.narrow(dim, 0, 1)), cum], dim=dim)


def specgram(audio: torch.Tensor, n_fft: int = 512, hop_length: int | None = None,
             mask: bool = True, log_mag: bool = True, re_im: bool = False,
             dphase: bool = True, mag_only: bool = False) -> torch.Tensor:
    """(log-mag, dphase) feature spectrogram (reference nsynth/utils.py:206-272)
    of ``audio`` [..., T]: [..., n_fft//2 + 1, n_frames, channels], channels 2
    (mag, phase feature) unless ``mag_only`` / ``re_im`` change it. Maxima are
    per clip (the last two dims of the spectrum)."""
    if hop_length is None:
        hop_length = n_fft // 2
    spec = centered_stft(audio, n_fft=n_fft, hop_length=hop_length)

    if re_im:
        return torch.stack([spec.real, spec.imag], dim=-1)

    per_clip = (-2, -1)
    mag = spec.abs()
    phase_angle = torch.angle(spec)
    if log_mag:
        mag = power_to_db(mag**2, amin=1e-13, top_db=120.0, dims=per_clip) / 120.0 + 1.0
    else:
        mag = mag / _amax(mag, per_clip)
    if dphase:
        pu = unwrap(phase_angle, dim=-1)
        p = torch.cat([pu[..., :1], pu[..., 1:] - pu[..., :-1]], dim=-1) / math.pi
    else:
        p = phase_angle / math.pi
    if log_mag and mask:
        p = mag * p
    if mag_only:
        return mag[..., None]
    return torch.stack([mag, p], dim=-1)


def inv_magphase(mag: torch.Tensor, phase_angle: torch.Tensor) -> torch.Tensor:
    return torch.polar(mag, phase_angle)


def griffin_lim(mag: torch.Tensor, phase_angle: torch.Tensor, n_fft: int, hop: int,
                num_iters: int) -> torch.Tensor:
    """Griffin-Lim phase retrieval (reference nsynth/utils.py:280-303): JAX's
    ``fori_loop`` of ``num_iters - 1`` iterations as a Python loop, then one
    last inverse from the final phase."""
    length = hop * (mag.shape[-1] - 1)
    for _ in range(num_iters - 1):
        audio = istft(inv_magphase(mag, phase_angle), n_fft=n_fft, hop_length=hop,
                      length=length)
        phase_angle = torch.angle(centered_stft(audio, n_fft=n_fft, hop_length=hop))
    return istft(inv_magphase(mag, phase_angle), n_fft=n_fft, hop_length=hop, length=length)


def ispecgram(spec: torch.Tensor, n_fft: int = 512, hop_length: int | None = None,
              mask: bool = True, log_mag: bool = True, re_im: bool = False,
              dphase: bool = True, mag_only: bool = True, num_iters: int = 1000,
              generator: torch.Generator | None = None) -> torch.Tensor:
    """Inverse specgram of one clip's [freq, time, channels] features
    (reference nsynth/utils.py:306-363), normalised by its peak.

    With ``mag_only`` the phase is recovered by Griffin-Lim from a uniform
    start in [0, pi) drawn on the host from ``generator`` (default: a
    ``torch.Generator`` seeded 0), so the card and the CPU start alike. JAX
    draws it from ``PRNGKey(0)``, whose bits torch cannot reproduce: the two
    start from different phases."""
    if hop_length is None:
        hop_length = n_fft // 2

    if mag_only:
        mag = spec[..., 0]
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        phase_angle = math.pi * torch.rand(mag.shape, generator=generator).to(mag.device)
    elif re_im:
        complex_spec = torch.complex(spec[..., 0], spec[..., 1])
        length = hop_length * (complex_spec.shape[-1] - 1)
        audio = istft(complex_spec, n_fft=n_fft, hop_length=hop_length, length=length)
        return audio / audio.max()
    else:
        mag, p = spec[..., 0], spec[..., 1]
        if mask and log_mag:
            p = p / (mag + 1e-13)
        phase_angle = torch.cumsum(p * math.pi, dim=-1) if dphase else p * math.pi

    if log_mag:
        mag = (mag - 1.0) * 120.0
        mag = 10.0 ** (mag / 20.0)

    if mag_only:
        audio = griffin_lim(mag, phase_angle, n_fft, hop_length, num_iters=num_iters)
    else:
        length = hop_length * (mag.shape[-1] - 1)
        audio = istft(inv_magphase(mag, phase_angle), n_fft=n_fft, hop_length=hop_length,
                      length=length)
    return torch.squeeze(audio / audio.max())
