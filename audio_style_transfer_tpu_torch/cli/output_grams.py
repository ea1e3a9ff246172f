"""Gram-visualization CLI (counterpart of
audio_style_transfer_tpu/cli/output_grams.py; mirror of reference
output-grams.py:110-124).

Slices a wav into fixed windows, computes each window's channel-wise grams
with the tapped encoder (``StyleTransfer.get_embeds(is_content=False)``: a
gradient-free trunk pass and one gram, on a CUDA device K1 and K5), and
saves a figure grid per window. The same flags as the JAX CLI, plus
``--device`` (default ``cuda``); the JAX CLI's ``enable_compile_cache`` call
has no counterpart.

    python -m audio_style_transfer_tpu_torch.cli.output_grams tone \
        --srcdir ./data/src --figdir ./data/fig --random_init
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("filename")
    p.add_argument("--srcdir", nargs="?", default="./data/src")
    p.add_argument("--figdir", nargs="?", default="./data/fig")
    p.add_argument("--stack", nargs="?", default=None, type=int)
    p.add_argument("--channels", nargs="?", default=128, type=int)
    p.add_argument("--length", nargs="?", default=16384, type=int)
    p.add_argument(
        "--ckpt_path", nargs="?",
        default="./nsynth/model/wavenet-ckpt/model.ckpt-200000",
    )
    p.add_argument("--random_init", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device the encoder runs on (cuda or cpu)")
    return p


def read_file(filename: str, length: int, sr: int = 16000):
    """Slice a file into len-`length` windows (reference output-grams.py:56-59)."""
    from audio_style_transfer_tpu_torch.utils.audio_io import load_audio

    aud, _ = load_audio(filename, sr=sr)
    if aud.ndim > 1:
        aud = aud[0]
    return [aud[i * length : (i + 1) * length] for i in range(len(aud) // length)]


def get_path(figdir: str, filename: str, stack, length: int) -> str:
    from audio_style_transfer_tpu_torch.utils.paths import crt_t_fol

    path = crt_t_fol(figdir)
    path = os.path.join(
        path, f"showAcrosslayer::chan0-127f:{filename}stack{stack}length{length}"
    )
    os.makedirs(path, exist_ok=True)
    return path


def window_grams(engine, audios) -> list[np.ndarray]:
    """Each window's style grams [channels, L, L] (L style taps), in order."""
    return [engine.get_embeds(aud, is_content=False) for aud in audios]


def make_engine(args):
    """The transfer engine of the run: seed-0 weights with ``--random_init``,
    else ``--ckpt_path``'s (the TF1 bundle, converted on first use, or its
    ``.npz``), loaded onto ``--device``."""
    from audio_style_transfer_tpu_torch.transfer import StyleTransfer, TransferSpec

    if args.random_init:
        from audio_style_transfer_tpu_torch.models import WaveNetAEConfig, init_params

        params = init_params(0, WaveNetAEConfig())
    else:
        from audio_style_transfer_tpu_torch.ckpt import load_pretrained

        params = load_pretrained(args.ckpt_path, device=args.device)
    spec = TransferSpec(
        stack=args.stack,
        batch_size=args.length,
        nb_channels=args.channels,
        write_artifacts=False,
        device=args.device,
    )
    return StyleTransfer(spec, params)


def main(argv=None):
    args = build_parser().parse_args(argv)

    from audio_style_transfer_tpu_torch.analysis.viz import show_our_gram

    engine = make_engine(args)
    filepath = os.path.join(args.srcdir, args.filename + ".wav")
    audios = read_file(filepath, args.length)
    figdir = get_path(args.figdir, args.filename, args.stack, args.length)

    for i, grams in enumerate(window_grams(engine, audios)):
        show_our_gram(grams, i, figdir)
        print(f"window {i}: gram grid saved")


if __name__ == "__main__":
    main()
