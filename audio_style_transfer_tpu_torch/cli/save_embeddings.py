"""Save-embeddings CLI (counterpart of audio_style_transfer_tpu/cli/save_embeddings.py,
mirror of reference nsynth_save_embeddings.py:29-129).

Encodes a directory of .wav files into .npy embeddings with the WaveNet
encoder. The same flags as the JAX CLI, plus ``--device`` (default ``cuda``):

    python -m audio_style_transfer_tpu_torch.cli.save_embeddings \
        --source_path wavs/ --save_path embeddings/ --checkpoint_path ckpt.npz
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--source_path", default="",
                   help="The directory of WAVs to yield embeddings from.")
    p.add_argument("--save_path", default="",
                   help="The directory to save the embeddings.")
    p.add_argument("--checkpoint_path", default="",
                   help="A path to the checkpoint. If not given, the latest "
                   "checkpoint in `expdir` will be used.")
    p.add_argument("--expdir", default="",
                   help="The log directory for this experiment. Required if "
                   "`checkpoint_path` is not given.")
    p.add_argument("--sample_length", type=int, default=64000)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--log", default="INFO")
    p.add_argument("--device", default="cuda",
                   help="torch device the encoder runs on (cuda or cpu)")
    return p


def latest_checkpoint(expdir: str) -> str:
    """Latest-checkpoint discovery (reference nsynth_save_embeddings.py:52-62):
    supports both TF1 ``checkpoint`` index files and .npz weights."""
    candidates = []  # (mtime source file, checkpoint path)
    for f in os.listdir(expdir):
        if f.endswith(".npz"):
            candidates.append((os.path.join(expdir, f), os.path.join(expdir, f)))
        elif f.endswith(".index"):
            candidates.append(
                (os.path.join(expdir, f), os.path.join(expdir, f[: -len(".index")]))
            )
    if not candidates:
        raise FileNotFoundError(f"no checkpoints in {expdir}")
    return max(candidates, key=lambda c: os.path.getmtime(c[0]))[1]


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.checkpoint_path:
        checkpoint_path = args.checkpoint_path
    else:
        if not os.path.exists(args.expdir):
            print(f"Experiment save dir '{args.expdir}' does not exist!")
            sys.exit(1)
        checkpoint_path = latest_checkpoint(args.expdir)

    from audio_style_transfer_tpu_torch.ckpt.convert import load_pretrained
    from audio_style_transfer_tpu_torch.generate import encode
    from audio_style_transfer_tpu_torch.utils.audio_io import load_audio_mono

    params = load_pretrained(checkpoint_path, device=args.device)
    os.makedirs(args.save_path, exist_ok=True)

    wavfiles = sorted(
        os.path.join(args.source_path, f)
        for f in os.listdir(args.source_path)
        if f.lower().endswith(".wav")
    )

    for start in range(0, len(wavfiles), args.batch_size):
        batch = wavfiles[start : start + args.batch_size]
        # Pad the batch with copies of the last file (reference :97-98)
        filler = args.batch_size - len(batch)
        padded = batch + filler * [batch[-1]]
        wav_data = np.array(
            [load_audio_mono(f, args.sample_length) for f in padded]
        )
        encoding = encode(wav_data, params, sample_length=args.sample_length)
        for wavfile, enc in zip(batch, encoding):
            filename = "%s_embeddings.npy" % os.path.basename(wavfile).replace(
                ".wav", ""
            )
            np.save(os.path.join(args.save_path, filename), enc)
            print(f"saved {filename} {enc.shape}")


if __name__ == "__main__":
    main()
