"""The port's NSynth examples (examples/how_to_use_torch.py,
examples/interpolation_torch.py) against the JAX ones.

``timestretch`` bit for bit; the flags, JAX's plus ``--device``; each
``main`` on the CPU at full width with random weights on a synthetic wav,
writing finite audio of encoding frames x 512 samples. The decoder runs one
eager step per sample here, about 16 ms each: interpolation's 1024-sample
case (2560 samples to generate) is ``slow``, its 512-sample case stays in
tier 1.
"""

import numpy as np
import pytest
from torch_helpers import parser_defaults

from audio_style_transfer_tpu_torch.utils.audio_io import read_wav, write_wav
from examples import how_to_use, how_to_use_torch, interpolation, interpolation_torch

HOP = 512


def _wav(path, freq: float, n: int = 2048):
    t = np.arange(n) / 16000.0
    write_wav(str(path), (0.5 * np.sin(2 * np.pi * freq * t)).astype(np.float32), 16000)


def _audio(path) -> np.ndarray:
    audio, sr = read_wav(str(path))
    assert sr == 16000
    return np.asarray(audio).reshape(-1)


@pytest.mark.parametrize("factor", [0.3, 0.5, 1.0, 1.5, 2.0, 3.7])
def test_timestretch_equals_jax_examples(factor):
    enc = np.random.RandomState(0).randn(2, 7, 16).astype(np.float32)
    got = interpolation_torch.timestretch(enc, factor)
    np.testing.assert_array_equal(got, interpolation.timestretch(enc, factor))
    assert got.shape == (2, max(int(round(7 * factor)), 1), 16)


@pytest.mark.parametrize("port, jax_main", [(how_to_use_torch, how_to_use.main),
                                            (interpolation_torch, interpolation.main)])
def test_flags_are_jax_flags_plus_device(port, jax_main, monkeypatch):
    want = parser_defaults(jax_main, monkeypatch)
    got = parser_defaults(port.main, monkeypatch, [])
    assert got.pop("device") == "cuda"
    assert got == want


def test_how_to_use_main_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    _wav(tmp_path / "tone.wav", 220.0)
    how_to_use_torch.main(["tone.wav", "--random_init", "--device", "cpu",
                           "--sample_length", "1024"])
    assert "synthesized gen_tone.wav" in capsys.readouterr().out
    enc = np.load(tmp_path / "tone.wav.npy")
    assert enc.shape == (1, 1024 // HOP, 16) and np.isfinite(enc).all()
    audio = _audio(tmp_path / "gen_tone.wav")
    assert audio.shape == (enc.shape[1] * HOP,) and np.isfinite(audio).all()


@pytest.mark.parametrize("sample_length", [512, pytest.param(1024, marks=pytest.mark.slow)])
def test_interpolation_main_on_the_cpu(sample_length, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    _wav(tmp_path / "a.wav", 220.0)
    _wav(tmp_path / "b.wav", 330.0)
    interpolation_torch.main(["a.wav", "b.wav", "--random_init", "--device", "cpu",
                              "--sample_length", str(sample_length)])
    out = capsys.readouterr().out
    assert "wrote interp.wav" in out and "wrote stretched.wav (x1.5)" in out
    frames = sample_length // HOP
    for name, n in (("interp.wav", frames), ("stretched.wav", round(frames * 1.5))):
        audio = _audio(tmp_path / name)
        assert audio.shape == (n * HOP,) and np.isfinite(audio).all(), name
