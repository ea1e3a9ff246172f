"""Encode -> synthesize walkthrough on the PyTorch port (reference
nsynth/how_to_use.py:1-48; counterpart of examples/how_to_use.py).

Loads a wav, encodes it with the WaveNet encoder, saves the embedding, and
regenerates audio with the port's sample loop (a CUDA graph per sample on
the card; the plain eager step on the CPU).

    python examples/how_to_use_torch.py content.wav --ckpt model.ckpt-200000
    python examples/how_to_use_torch.py content.wav --random_init --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("filename")
    parser.add_argument("--ckpt", default="./nsynth/model/wavenet-ckpt/model.ckpt-200000")
    parser.add_argument("--sample_length", type=int, default=40000)
    parser.add_argument("--random_init", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from audio_style_transfer_tpu_torch.generate import encode, synthesize
    from audio_style_transfer_tpu_torch.models import WaveNetAEConfig, init_params
    from audio_style_transfer_tpu_torch.utils.audio_io import load_audio_mono

    sampling_rate = 16000
    audio = load_audio_mono(args.filename, sample_length=args.sample_length,
                            sr=sampling_rate)
    sample_length = audio.shape[0]
    print(f"{sample_length} samples, {sample_length / sampling_rate} seconds")

    if args.random_init:
        params = init_params(0, WaveNetAEConfig(), device=args.device)
    else:
        from audio_style_transfer_tpu_torch.ckpt import load_pretrained

        params = load_pretrained(args.ckpt, args.device)

    encoding = encode(audio, params, sample_length)
    print("encoding shape", encoding.shape)
    np.save(args.filename + ".npy", encoding)

    synthesize(encoding, save_paths=["gen_" + args.filename.split("/")[-1]],
               params=params)
    print("synthesized", "gen_" + args.filename.split("/")[-1])


if __name__ == "__main__":
    main()
