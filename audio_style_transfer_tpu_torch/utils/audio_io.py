"""Waveform file IO without librosa (the port's own copy of
audio_style_transfer_tpu/utils/audio_io.py: ``read_wav``, ``write_wav``,
``resample``, ``load_audio``, ``load_audio_mono``, ``trim_for_encoding``).

The reference leans on librosa/audioread for decoding + resampling
(reference utils.py:260-264, nsynth/utils.py:54-67).  This image has no
librosa, and file IO is host-side anyway, so we read/write RIFF WAVs with
the stdlib ``wave`` module and resample with a polyphase FIR
(scipy.signal.resample_poly) — the same class of kernel librosa's
``res_type='soxr_hq'`` implements.
"""

from __future__ import annotations

import math
import wave

import numpy as np


def read_wav(path: str):
    """Read a PCM/float RIFF WAV. Returns (audio [channels, T] float32 in [-1,1], sr)."""
    with wave.open(str(path), "rb") as w:
        n_channels = w.getnchannels()
        sampwidth = w.getsampwidth()
        sr = w.getframerate()
        n_frames = w.getnframes()
        raw = w.readframes(n_frames)

    if sampwidth == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sampwidth == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif sampwidth == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        vals = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        data = vals.astype(np.float32) / float(1 << 23)
    else:  # pragma: no cover
        raise ValueError(f"Unsupported WAV sample width: {sampwidth}")

    audio = data.reshape(-1, n_channels).T
    return np.ascontiguousarray(audio), sr


def write_wav(path: str, audio, sr: int):
    """Write float audio in [-1, 1] (1-D or [channels, T]) as 16-bit PCM WAV."""
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 1:
        audio = audio[None, :]
    pcm = np.clip(audio, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(pcm.shape[0])
        w.setsampwidth(2)
        w.setframerate(int(sr))
        w.writeframes(pcm.T.tobytes())


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase FIR resampling along the last axis."""
    if orig_sr == target_sr:
        return audio
    from scipy.signal import resample_poly

    g = math.gcd(int(orig_sr), int(target_sr))
    return resample_poly(audio, target_sr // g, orig_sr // g, axis=-1).astype(
        np.float32
    )


def load_audio(fn: str, sr: int | None = None, audio_channel: int | None = None):
    """librosa.load(mono=False)-alike (reference utils.py:260-264).

    Returns (audio, sr). With ``audio_channel`` set (or a mono file), the
    result is 1-D; otherwise [channels, T].
    """
    audio, file_sr = read_wav(fn)
    if sr is not None and sr != file_sr:
        audio = resample(audio, file_sr, sr)
    else:
        sr = file_sr
    if audio.shape[0] == 1:
        return audio[0], sr
    if audio_channel is not None:
        return audio[audio_channel], sr
    return audio, sr


def load_audio_mono(path: str, sample_length: int = 64000, sr: int = 16000):
    """nsynth-style loader (reference nsynth/utils.py:54-67): mono + truncate."""
    audio, _ = load_audio(path, sr=sr)
    if audio.ndim > 1:
        audio = audio.mean(axis=0)
    return audio[:sample_length]


def trim_for_encoding(wav_data: np.ndarray, sample_length: int, hop_length: int = 512):
    """Trim audio to a multiple of hop_length (reference nsynth/utils.py:139-169)."""
    if wav_data.ndim == 1:
        sample_length = min(sample_length, wav_data.size)
        sample_length = (sample_length // hop_length) * hop_length
        return wav_data[:sample_length], sample_length
    sample_length = min(sample_length, wav_data.shape[-1])
    sample_length = (sample_length // hop_length) * hop_length
    return wav_data[:, :sample_length], sample_length
