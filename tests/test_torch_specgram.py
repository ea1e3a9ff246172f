"""The port's spectrogram chain against the JAX package's, on the CPU in
float32: ``centered_stft`` / ``istft`` (signal/stft.py), ``power_to_db``,
``unwrap``, ``specgram``, ``griffin_lim``, ``ispecgram``
(signal/specgram.py) and ``NSynthDataset.get_baseline_batch``
(data/nsynth.py).

Tolerances: both packages take float32 FFTs (pocketfft in JAX, the port's
torch FFT) and sum in other orders. Spectra and audio agree to 1e-5 of their
largest entry (``RTOL``), dB features to 1e-4 (a dB is a log: an error of
1e-7 relative near the -120 dB floor is 1e-4 of the feature's range).
Phase features are the exception that the math allows: where a bin's phase
or a frame-to-frame difference sits on +-pi, the two FFTs' last bits put it
on either side, and the feature differs by 2 (by 2 x mag under the mask).
The first frame is such a case throughout: reflect-padded about sample 0 and
windowed by a Hann window symmetric about its centre, its spectrum is real,
so a bin with a negative real part has the angle +pi or -pi by the sign of
a rounding-level imaginary part. Flips are allowed there, and on at most
``FLIP_SHARE`` of the other entries; every other entry is held to
``PHASE_TOL`` (a bin 60 dB below the clip's peak holds its angle to about
1e-4 of pi: the FFT's float32 error, 1e-7 of the peak, over its magnitude;
a dphase feature is the difference of two angles).
"""

import importlib
import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_helpers  # noqa: F401  (two torch threads)

from audio_style_transfer_tpu.signal import specgram as jsg
from audio_style_transfer_tpu_torch.signal import specgram as tsg

# The modules, not the ``stft`` functions their packages re-export.
jst = importlib.import_module("audio_style_transfer_tpu.signal.stft")
tst = importlib.import_module("audio_style_transfer_tpu_torch.signal.stft")

RTOL = 1e-5
DB_TOL = 1e-4
PHASE_TOL = 1e-3
FLIP_SHARE = 1e-3


def _close(got, want, rtol=RTOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rtol * max(float(np.abs(want).max()), 1e-30), (what, err)


def _audio(n=4000, seed=0, gain=0.5):
    """Tones plus noise: every bin carries energy (a well-defined phase)."""
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    x = sum(rng.uniform(0.1, 0.3) * np.sin(2 * np.pi * f * t + rng.uniform(0, 6))
            for f in 110.0 * 2 ** rng.uniform(0, 5, 4))
    return (gain * (x + 0.05 * rng.randn(n))).astype(np.float32)


@pytest.mark.parametrize("n_fft,hop", [(512, 256), (1024, 256), (64, 16)])
def test_centered_stft_matches_jax(n_fft, hop):
    x = _audio()
    want = jst.centered_stft(jnp.asarray(x), n_fft=n_fft, hop_length=hop)
    got = tst.centered_stft(torch.tensor(x), n_fft=n_fft, hop_length=hop)
    assert got.shape == want.shape == (n_fft // 2 + 1, 1 + len(x) // hop)
    _close(got.real, np.real(want))
    _close(got.imag, np.imag(want))


def test_centered_stft_takes_a_batch_and_the_512_wrapper():
    x = np.stack([_audio(seed=s) for s in range(3)])
    got = tst._centered_stft_512(torch.tensor(x))
    for i in range(3):
        want = jst.centered_stft(jnp.asarray(x[i]), n_fft=512, hop_length=256)
        _close(got[i].real, np.real(want))
        _close(got[i].imag, np.imag(want))


@pytest.mark.parametrize("n_fft,hop", [(512, 256), (1024, 256), (64, 24)])
def test_istft_matches_jax_and_inverts(n_fft, hop):
    """JAX's istft of the same spectrum, the round trip back to the clip,
    and a batch of clips at once."""
    x = np.stack([_audio(seed=s) for s in range(2)])
    spec = np.asarray(jst.centered_stft(jnp.asarray(x), n_fft=n_fft, hop_length=hop))
    length = hop * (spec.shape[-1] - 1)
    want = jst.istft(jnp.asarray(spec), n_fft=n_fft, hop_length=hop, length=length)
    got = tst.istft(torch.tensor(spec), n_fft=n_fft, hop_length=hop, length=length)
    _close(got, want)
    round_trip = tst.istft(tst.centered_stft(torch.tensor(x), n_fft, hop), n_fft, hop)
    assert round_trip.shape[-1] == length  # hop x (frames - 1): the clip's whole hops
    _close(round_trip, x[:, :length], rtol=1e-5)


def test_power_to_db_matches_jax():
    rng = np.random.RandomState(1)
    p = (10.0 ** rng.uniform(-16, 2, (64, 40))).astype(np.float32)
    for top_db in (120.0, 80.0):
        want = jsg.power_to_db(jnp.asarray(p), amin=1e-13, top_db=top_db)
        got = tsg.power_to_db(torch.tensor(p), amin=1e-13, top_db=top_db)
        _close(got, want, rtol=DB_TOL)
    batch = np.stack([p, p * 1e-6])  # the per-clip max of ``dims``
    got = tsg.power_to_db(torch.tensor(batch), dims=(-2, -1))
    for i in range(2):
        _close(got[i], jsg.power_to_db(jnp.asarray(batch[i])), rtol=DB_TOL)


def test_unwrap_matches_jax_and_numpy_with_the_pi_tie():
    """Random phases, and jumps of exactly +pi and -pi (float32): numpy's
    rule keeps +pi for an upward jump of pi, -pi for a downward one."""
    rng = np.random.RandomState(2)
    p = rng.uniform(-np.pi, np.pi, (6, 50)).astype(np.float32)
    pi = np.float32(np.pi)
    ties = np.array([[0.0, pi, 0.0, -pi, -2 * pi, pi, 2 * pi, 3 * pi]], np.float32)
    for arr in (p, ties):
        want = np.asarray(jsg.unwrap(jnp.asarray(arr), axis=-1))
        got = tsg.unwrap(torch.tensor(arr), dim=-1).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got, np.unwrap(arr, axis=-1), rtol=0, atol=1e-5)
    want = np.asarray(jsg.unwrap(jnp.asarray(p), axis=0))
    np.testing.assert_allclose(tsg.unwrap(torch.tensor(p), dim=0).numpy(), want, atol=1e-5)


def _phase_close(got, want, mag, what):
    """[freq, time] phase features: |d| <= PHASE_TOL except flips by 2 (x mag
    under the mask) in the first frame and on at most FLIP_SHARE of the other
    entries."""
    d = np.abs(got - want)
    off = d > PHASE_TOL
    assert off[..., 1:].mean() <= FLIP_SHARE, (what, off[..., 1:].mean())
    flips = np.abs(d[off] - 2.0 * mag[off])
    assert np.all(flips <= PHASE_TOL), (what, flips.max())


FLAGS = [
    dict(),  # the reference's default: log-mag, dphase, mask
    dict(mask=False),
    dict(dphase=False),
    dict(log_mag=False),
    dict(log_mag=False, dphase=False),
    dict(mag_only=True),
    dict(re_im=True),
]


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: ",".join(f"{k}={v}" for k, v in f.items())
                         or "default")
@pytest.mark.parametrize("n_fft,hop", [(512, 256), (1024, 256)])
def test_specgram_matches_jax_under_each_flag(flags, n_fft, hop):
    x = _audio(16000)
    want = np.asarray(jsg.specgram(jnp.asarray(x), n_fft=n_fft, hop_length=hop, **flags))
    got = tsg.specgram(torch.tensor(x), n_fft=n_fft, hop_length=hop, **flags).numpy()
    assert got.shape == want.shape
    if flags.get("re_im"):
        _close(got, want)
        return
    _close(got[..., 0], want[..., 0], rtol=DB_TOL if flags.get("log_mag", True) else RTOL,
           what="mag")
    if not flags.get("mag_only"):
        masked = flags.get("log_mag", True) and flags.get("mask", True)
        mag = want[..., 0] if masked else np.ones_like(want[..., 0])
        _phase_close(got[..., 1], want[..., 1], mag, str(flags))


def test_specgram_of_a_batch_normalises_each_clip_by_its_own_max():
    """Clips 60 dB apart in one batch: each equals JAX's specgram of that clip
    alone (a max over the batch would floor the quiet one)."""
    x = np.stack([_audio(8000, seed=3, gain=1e-3), _audio(8000, seed=4, gain=0.9)])
    got = tsg.specgram(torch.tensor(x), n_fft=512, hop_length=256).numpy()
    for i in range(2):
        want = np.asarray(jsg.specgram(jnp.asarray(x[i]), n_fft=512, hop_length=256))
        _close(got[i, ..., 0], want[..., 0], rtol=DB_TOL)
        _phase_close(got[i, ..., 1], want[..., 1], want[..., 0], f"clip {i}")


def test_griffin_lim_matches_jax_from_a_carried_phase():
    """The same magnitude and start phase into both: each returns the audio
    after ``num_iters - 1`` projections; the spectral convergence (||S| -
    |STFT(y)||| / ||S||) falls with iterations in both."""
    n_fft, hop = 512, 128
    x = _audio(4096)
    mag = np.abs(np.asarray(jst.centered_stft(jnp.asarray(x), n_fft, hop))).astype(np.float32)
    phase = np.random.RandomState(5).uniform(0, np.pi, mag.shape).astype(np.float32)

    def convergence(y):
        s = np.abs(np.asarray(jst.centered_stft(jnp.asarray(y), n_fft, hop)))
        return float(np.linalg.norm(s - mag) / np.linalg.norm(mag))

    conv = []
    for iters in (1, 8):
        want = np.asarray(jsg.griffin_lim(jnp.asarray(mag), jnp.asarray(phase), n_fft, hop,
                                          iters))
        got = tsg.griffin_lim(torch.tensor(mag), torch.tensor(phase), n_fft, hop, iters)
        _close(got, want, rtol=1e-4, what=f"{iters} iterations")
        conv.append(convergence(got.numpy()))
    assert conv[1] < conv[0]


def _features(x, **flags):
    return np.asarray(jsg.specgram(jnp.asarray(x), n_fft=512, hop_length=256, **flags))


@pytest.mark.parametrize("flags", [dict(re_im=True, mag_only=False),
                                   dict(mag_only=False),
                                   dict(mag_only=False, mask=False),
                                   dict(mag_only=False, dphase=False, mask=False)],
                         ids=["re_im", "dphase masked", "dphase", "phase"])
def test_ispecgram_branches_match_jax(flags):
    """re_im, and the (mag, phase) branches: JAX's features into both."""
    x = _audio(8192, seed=6)
    spec = _features(x, **{k: v for k, v in flags.items() if k != "mag_only"})
    want = np.asarray(jsg.ispecgram(jnp.asarray(spec), n_fft=512, hop_length=256, **flags))
    got = tsg.ispecgram(torch.tensor(spec), n_fft=512, hop_length=256, **flags)
    _close(got, want, rtol=1e-4, what=str(flags))


def test_ispecgram_mag_only_is_griffin_lim_from_the_generator_phase():
    """mag_only: the port's start phase is pi x U[0, 1) from a
    torch.Generator seeded 0 (JAX's PRNGKey(0) bits differ); from that phase
    JAX's griffin_lim gives the same audio."""
    x = _audio(8192, seed=7)
    spec = _features(x, mag_only=True)
    got = tsg.ispecgram(torch.tensor(spec), n_fft=512, hop_length=256, num_iters=5)
    phase = math.pi * torch.rand(spec.shape[:-1], generator=torch.Generator().manual_seed(0))
    mag = 10.0 ** ((spec[..., 0] - 1.0) * 120.0 / 20.0)
    ref = np.asarray(jsg.griffin_lim(jnp.asarray(mag), jnp.asarray(phase.numpy()), 512, 256, 5))
    _close(got, np.squeeze(ref / ref.max()), rtol=1e-4)
    again = tsg.ispecgram(torch.tensor(spec), n_fft=512, hop_length=256, num_iters=5)
    assert torch.equal(got, again)


def _write_records(path, clips):
    from audio_style_transfer_tpu_torch.data import build_example, write_tfrecord

    write_tfrecord(path, [build_example({
        "note_str": f"note-{i}".encode(), "pitch": np.array([40 + 7 * i], np.int64),
        "audio": c}) for i, c in enumerate(clips)])


@pytest.mark.parametrize("is_training", [True, False])
def test_get_baseline_batch_matches_jax(tmp_path, is_training):
    """A synthetic TFRecord of 64000-sample clips whose loudness spans 80 dB
    (a max over the batch would floor the quiet ones): the port's batches
    (specgram on the CPU) against JAX's, key by key, at nfft_1024 in the
    reference's mag-only features and in (mag, dphase)."""
    from audio_style_transfer_tpu.data.nsynth import NSynthDataset as JData
    from audio_style_transfer_tpu.models.baseline_ae import BaselineHParams as JHP
    from audio_style_transfer_tpu_torch.data.nsynth import NSynthDataset as TData
    from audio_style_transfer_tpu_torch.models.baseline_ae import BaselineHParams as THP

    gains = [1e-4, 0.9, 3e-3, 0.3]
    clips = [_audio(64000, seed=10 + i, gain=g) for i, g in enumerate(gains)]
    path = str(tmp_path / "b.tfrecord")
    _write_records(path, clips)
    # The Python reader: the native one's threads may interleave the repeated
    # file in another order (tests/test_torch_data.py holds the two readers).
    kw = dict(is_training=is_training, use_native=False)
    for mag_only in (True, False):  # training repeats the records forever: 2 batches
        jb = list(itertools.islice(JData(path, **kw).get_baseline_batch(
            JHP(batch_size=2, mag_only=mag_only)), 2))
        tb = list(itertools.islice(TData(path, **kw).get_baseline_batch(
            THP(batch_size=2, mag_only=mag_only), device="cpu"), 2))
        assert len(tb) == len(jb) == 2
        for g, w in zip(tb, jb):
            assert set(g) == set(w) == {"audio", "pitch", "spectrogram", "key"}
            assert g["key"] == w["key"]
            np.testing.assert_array_equal(g["pitch"], w["pitch"])
            np.testing.assert_array_equal(g["audio"], w["audio"])
            assert isinstance(g["spectrogram"], np.ndarray)
            assert g["spectrogram"].dtype == w["spectrogram"].dtype == np.float32
            assert g["spectrogram"].shape == w["spectrogram"].shape == \
                (2, 512, 256, 1 if mag_only else 2)
            for i in range(2):  # per clip: each clip's own range
                _close(g["spectrogram"][i, ..., 0], w["spectrogram"][i, ..., 0], rtol=DB_TOL)
                if not mag_only:
                    _phase_close(g["spectrogram"][i, ..., 1], w["spectrogram"][i, ..., 1],
                                 w["spectrogram"][i, ..., 0], "dphase")
            assert not np.any(g["spectrogram"][:, :, 251:])  # the time pad
