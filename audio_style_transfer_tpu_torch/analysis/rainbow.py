"""NSynth-paper rainbowgram plots (counterpart of
audio_style_transfer_tpu/analysis/rainbow.py; reference rainbowgram.py).

CQT magnitude rendered as an alpha mask over the phase-derivative rainbow,
with the reference's constants (n_fft 512, hop 256, 40 bins/octave, 240
bins, filter_scale 0.8, fmin C2, peak 80 dB) and its alpha-only colormap
(reference rainbowgram.py:21-35).

Two CQT backends: ``"multirate"`` (the default for plots) is the float64
host transform of signal/cqt_multirate.py, the recursive-downsampling
algorithm librosa runs where the reference computes its CQT, and the dB /
phase features follow on the host; ``"device"`` is the port's ``cqt`` (one
matrix product on ``device``), features on that device too. matplotlib is
imported at the call.
"""

from __future__ import annotations

import numpy as np

# Constants (reference rainbowgram.py:11-18)
N_FFT = 512
HOP_LENGTH = 256
SR = 16000
OVER_SAMPLE = 4
RES_FACTOR = 0.8
OCTAVES = 6
NOTES_PER_OCTAVE = 10

_CDICT = {
    "red": ((0.0, 0.0, 0.0), (1.0, 0.0, 0.0)),
    "green": ((0.0, 0.0, 0.0), (1.0, 0.0, 0.0)),
    "blue": ((0.0, 0.0, 0.0), (1.0, 0.0, 0.0)),
    "alpha": ((0.0, 1.0, 1.0), (1.0, 0.0, 0.0)),
}


def _mask_cmap():
    import matplotlib

    return matplotlib.colors.LinearSegmentedColormap("MyMask", _CDICT)


def rainbowgram(
    audio,
    sr: int = SR,
    peak: float = 80.0,
    n_fft: int = N_FFT,
    hop_length: int | None = None,
    over_sample: int = OVER_SAMPLE,
    res_factor: float = RES_FACTOR,
    octaves: int = OCTAVES,
    notes_per_octave: int = NOTES_PER_OCTAVE,
    cqt_override=None,
    backend: str = "multirate",
    device="cuda",
):
    """(mag, dphase) numpy arrays [n_bins, n_frames] for plotting (reference
    rainbowgram.py:37-62).

    ``backend``: "multirate" (the host float64 recursive-downsampling
    algorithm) or "device" (the port's ``cqt`` on ``device``).
    ``cqt_override``: a precomputed complex CQT [n_bins, n_frames], rendered
    on the host (the fidelity tests render an oracle's transform this way).
    """
    import torch

    from audio_style_transfer_tpu_torch.signal.cqt import C2_HZ, cqt
    from audio_style_transfer_tpu_torch.signal.specgram import power_to_db, unwrap

    if not hop_length:
        hop_length = n_fft // 2
    geometry = dict(sr=sr, hop_length=hop_length,
                    bins_per_octave=int(notes_per_octave * over_sample),
                    n_bins=int(octaves * notes_per_octave * over_sample),
                    filter_scale=res_factor, fmin=C2_HZ)

    if cqt_override is not None:
        c = torch.from_numpy(np.asarray(cqt_override, np.complex64))
    elif backend == "multirate":
        from audio_style_transfer_tpu_torch.signal.cqt_multirate import multirate_cqt

        c = torch.from_numpy(
            multirate_cqt(np.asarray(audio, np.float64), **geometry).astype(np.complex64))
    elif backend == "device":
        c = cqt(torch.as_tensor(np.asarray(audio, np.float32), device=device), **geometry)
    else:
        raise ValueError(f"unknown rainbowgram backend {backend!r}")
    mag = c.abs()
    phase_angle = torch.angle(c)

    mag = (power_to_db(mag**2, amin=1e-13, top_db=peak) / peak) + 1
    phase_unwrapped = unwrap(phase_angle, dim=-1)
    p = phase_unwrapped[:, 1:] - phase_unwrapped[:, :-1]
    p = torch.cat([phase_unwrapped[:, 0:1], p], dim=1) / np.pi
    return mag.cpu().numpy(), p.cpu().numpy()


def plotcqt(filepath: str, savepath: str | None = None):
    """Render the rainbowgram of a wav file (reference rainbowgram.py:64-75)
    from the host transform."""
    import matplotlib

    matplotlib.use("agg")
    from matplotlib import pyplot as plt

    from audio_style_transfer_tpu_torch.utils.audio_io import read_wav

    audio, sr = read_wav(filepath)
    # scipy.io.wavfile semantics: int16 counts as float
    mag, p = rainbowgram(audio[0] * 32768.0, sr)
    fig, ax = plt.subplots()
    ax.matshow(p[::-1, :], cmap=plt.cm.rainbow)
    ax.matshow(mag[::-1, :], cmap=_mask_cmap())
    if savepath:
        plt.savefig(savepath)
    plt.close(fig)
    return mag, p
