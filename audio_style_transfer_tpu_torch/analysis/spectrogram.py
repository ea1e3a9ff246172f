"""Log-frequency STFT spectrogram plots, bit-faithful to the reference (the
port's own copy of audio_style_transfer_tpu/analysis/spectrogram.py).

Reproduces reference spectrogram.py (Frank Zalkow's public-domain-style
plotting script) numerically: same pre-pad (half frame of zeros so the
first window is centered on sample 0), same column count formula, same
log-scale frequency binning with summed complex bins, same dB mapping
``20*log10(|S|/10e-6)``.  The north star requires these renderings to match
the reference, so this path intentionally stays in numpy on the host; the
device-side STFT lives in signal/stft.py.
"""

from __future__ import annotations

import numpy as np


def stft_np(sig: np.ndarray, frame_size: int, overlap_fac: float = 0.5) -> np.ndarray:
    """Zero-padded, Hann-windowed STFT (reference spectrogram.py:15-31)."""
    win = np.hanning(frame_size)
    hop_size = int(frame_size - np.floor(overlap_fac * frame_size))

    samples = np.append(np.zeros(int(np.floor(frame_size / 2.0))), sig)
    cols = int(np.ceil((len(samples) - frame_size) / float(hop_size)) + 1)
    samples = np.append(samples, np.zeros(frame_size))

    idx = np.arange(cols)[:, None] * hop_size + np.arange(frame_size)[None, :]
    frames = samples[idx] * win
    return np.fft.rfft(frames)


def logscale_spec(spec: np.ndarray, sr: int = 44100, factor: float = 20.0):
    """Sum FFT bins into log-spaced bins (reference spectrogram.py:34-58).

    The bin edges are ``unique(round(linspace(0,1,F)^factor * (F-1)))`` and
    each output bin sums the complex input bins in [edge_i, edge_{i+1})
    (the last bin absorbs the remainder). Implemented with a single
    ``add.reduceat`` over the edges instead of a per-bin loop; numerically
    identical to the reference (verified to 1e-10 in tests/test_viz.py).
    """
    timebins, freqbins = np.shape(spec)

    edges = np.linspace(0, 1, freqbins) ** factor
    edges *= (freqbins - 1) / max(edges)
    edges = np.unique(np.round(edges)).astype(int)

    newspec = np.add.reduceat(spec.astype(np.complex128), edges, axis=1)

    # center frequency of each output bin = mean of its input bins' freqs
    allfreqs = np.abs(np.fft.fftfreq(freqbins * 2, 1.0 / sr)[: freqbins + 1])
    bounds = np.append(edges, len(allfreqs))
    freqs = [
        float(np.mean(allfreqs[bounds[i] : bounds[i + 1]]))
        for i in range(len(edges))
    ]
    return newspec, freqs


def plotstft(audiopath: str, binsize: int = 2**10, plotpath: str | None = None,
             colormap: str = "jet"):
    """Render the dB spectrogram of a wav file (reference spectrogram.py:61-89)."""
    import matplotlib

    matplotlib.use("agg")
    from matplotlib import pyplot as plt

    from audio_style_transfer_tpu_torch.utils.audio_io import read_wav

    audio, samplerate = read_wav(audiopath)
    # scipy.io.wavfile returns int16 counts; reproduce that scale.
    samples = (audio[0] * 32768.0).astype(np.float64)
    s = stft_np(samples, binsize)

    sshow, freq = logscale_spec(s, factor=1.0, sr=samplerate)
    with np.errstate(divide="ignore"):
        ims = 20.0 * np.log10(np.abs(sshow) / 10e-6)

    timebins, freqbins = np.shape(ims)

    plt.figure(figsize=(15, 7.5))
    plt.imshow(
        np.transpose(ims), origin="lower", aspect="auto",
        cmap=colormap, interpolation="none",
    )
    plt.colorbar()
    plt.xlabel("time (s)")
    plt.ylabel("frequency (hz)")
    plt.xlim([0, timebins - 1])
    plt.ylim([0, freqbins])

    xlocs = np.float32(np.linspace(0, timebins - 1, 5))
    plt.xticks(
        xlocs,
        ["%.02f" % l for l in ((xlocs * len(samples) / timebins) + (0.5 * binsize)) / samplerate],
    )
    ylocs = np.int16(np.round(np.linspace(0, freqbins - 1, 10)))
    plt.yticks(ylocs, ["%.02f" % freq[i] for i in ylocs])

    if plotpath:
        plt.savefig(plotpath, bbox_inches="tight")
    plt.clf()
    plt.close("all")
    return ims
