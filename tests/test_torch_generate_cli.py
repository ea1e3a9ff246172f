"""The port's generation CLIs (cli/save_embeddings.py, cli/generate.py)
against the JAX package's: the same flags plus ``--device``, the same file
discovery and checkpoint discovery on the same temp dirs, and one run end to
end on the CPU at full width (save_embeddings, then generate from the saved
embeddings), with the embedding held to JAX's ``encode`` on the same weights.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import jax_params_np

from audio_style_transfer_tpu.cli import generate as jgenerate
from audio_style_transfer_tpu.cli import save_embeddings as jsave
from audio_style_transfer_tpu.generate import fastgen as jfastgen
from audio_style_transfer_tpu_torch.cli import generate, save_embeddings
from audio_style_transfer_tpu_torch.utils.audio_io import load_audio_mono, read_wav, write_wav


def _options(parser) -> dict:
    return {a.dest: (tuple(a.option_strings), a.default) for a in parser._actions}


@pytest.mark.parametrize("mine,theirs", [(generate, jgenerate), (save_embeddings, jsave)])
def test_parsers_have_the_jax_flags_plus_device(mine, theirs):
    got, want = _options(mine.build_parser()), _options(theirs.build_parser())
    assert got.pop("device") == (("--device",), "cuda")
    assert got == want


def test_discover_files_matches_jax(tmp_path):
    both = tmp_path / "both"
    npy = tmp_path / "npy"
    other = tmp_path / "other"
    for d in (both, npy, other):
        d.mkdir()
    for name in ("b.wav", "a.WAV", "c.npy", "z.txt"):
        (both / name).write_bytes(b"")
    for name in ("y.npy", "x.npy"):
        (npy / name).write_bytes(b"")
    (other / "z.txt").write_bytes(b"")
    for source in (both, npy, both / "b.wav", npy / "x.npy", tmp_path / "nothing.mp3"):
        for npy_only in (False, True):
            assert generate.discover_files(str(source), npy_only) == \
                   jgenerate.discover_files(str(source), npy_only)
    with pytest.raises(RuntimeError):
        generate.discover_files(str(other))


def test_latest_checkpoint_matches_jax(tmp_path):
    for i, name in enumerate(("old.npz", "model.ckpt-5.index", "model.ckpt-9.index", "x.txt")):
        (tmp_path / name).write_bytes(b"")
        os.utime(tmp_path / name, (1000 + i, 1000 + i))
    got = save_embeddings.latest_checkpoint(str(tmp_path))
    assert got == jsave.latest_checkpoint(str(tmp_path)) == str(tmp_path / "model.ckpt-9")
    os.utime(tmp_path / "old.npz", (2000, 2000))
    assert save_embeddings.latest_checkpoint(str(tmp_path)) == str(tmp_path / "old.npz")
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        save_embeddings.latest_checkpoint(str(tmp_path / "empty"))


def test_generate_refuses_bf16_with_int8(tmp_path):
    with pytest.raises(SystemExit):
        generate.main(["--save_path", str(tmp_path), "--bf16", "--int8", "--device", "cpu"])


def test_save_embeddings_then_generate_on_the_cpu_at_full_width(tmp_path):
    """Full width, JAX's seed-0 weights as the .npz both packages read; one
    1024-sample wav (2 frames)."""
    torch.set_num_threads(2)
    p = jax_params_np(0)
    ckpt = str(tmp_path / "w.npz")
    np.savez(ckpt, **{f"{layer}/{k}": v for layer, e in p.items() for k, v in e.items()})
    wavs, emb, out = tmp_path / "wavs", tmp_path / "emb", tmp_path / "out"
    wavs.mkdir()
    t = np.arange(1100) / 16000.0
    write_wav(str(wavs / "tone.wav"), (0.5 * np.sin(2 * np.pi * 330.0 * t)).astype(np.float32),
              16000)

    save_embeddings.main(["--source_path", str(wavs), "--save_path", str(emb),
                          "--checkpoint_path", ckpt, "--device", "cpu", "--batch_size", "2"])
    enc = np.load(emb / "tone_embeddings.npy")
    assert enc.shape == (2, 16) and np.all(np.isfinite(enc))
    jp = {k: {m: jnp.asarray(v) for m, v in e.items()} for k, e in p.items()}
    want = jfastgen.encode(load_audio_mono(str(wavs / "tone.wav"))[None], jp)[0]
    assert np.abs(enc - want).max() <= 1e-4 * np.abs(want).max() + 1e-5

    generate.main(["--source_path", str(emb), "--save_path", str(out), "--checkpoint_path",
                   ckpt, "--device", "cpu", "--seed", "3"])
    audio, sr = read_wav(str(out / "gen_tone_embeddings.wav"))
    assert sr == 16000 and audio.shape == (1, 1024)
    assert np.all(np.isfinite(audio)) and np.abs(audio).max() > 0
