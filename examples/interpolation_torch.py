"""Embedding interpolation + timestretch recipes on the PyTorch port
(reference NSynth.ipynb; counterpart of examples/interpolation.py).

The notebook's two tricks:
* interpolate between two clips' encodings and synthesize the blend;
* timestretch a clip by resampling its encoding along time before
  synthesis (audio length = encoding length x hop).

    python examples/interpolation_torch.py a.wav b.wav --random_init
    python examples/interpolation_torch.py a.wav b.wav --random_init --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def timestretch(encoding: np.ndarray, factor: float) -> np.ndarray:
    """Linear time-resampling of a [B, T, Z] encoding (notebook recipe)."""
    b, t, z = encoding.shape
    new_t = max(int(round(t * factor)), 1)
    src = np.linspace(0.0, t - 1.0, new_t)
    lo = np.floor(src).astype(int)
    hi = np.minimum(lo + 1, t - 1)
    frac = (src - lo)[None, :, None]
    return encoding[:, lo, :] * (1 - frac) + encoding[:, hi, :] * frac


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("file_a")
    parser.add_argument("file_b")
    parser.add_argument("--ckpt", default="./nsynth/model/wavenet-ckpt/model.ckpt-200000")
    parser.add_argument("--sample_length", type=int, default=32000)
    parser.add_argument("--stretch", type=float, default=1.5)
    parser.add_argument("--mix", type=float, default=0.5)
    parser.add_argument("--random_init", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from audio_style_transfer_tpu_torch.generate import encode, synthesize
    from audio_style_transfer_tpu_torch.models import WaveNetAEConfig, init_params
    from audio_style_transfer_tpu_torch.utils.audio_io import load_audio_mono

    if args.random_init:
        params = init_params(0, WaveNetAEConfig(), device=args.device)
    else:
        from audio_style_transfer_tpu_torch.ckpt import load_pretrained

        params = load_pretrained(args.ckpt, args.device)

    a = load_audio_mono(args.file_a, args.sample_length)
    b = load_audio_mono(args.file_b, args.sample_length)
    enc_a = encode(a, params, args.sample_length)
    enc_b = encode(b, params, args.sample_length)

    n = min(enc_a.shape[1], enc_b.shape[1])
    blend = args.mix * enc_a[:, :n] + (1 - args.mix) * enc_b[:, :n]
    synthesize(blend, ["interp.wav"], params=params)
    print("wrote interp.wav")

    stretched = timestretch(enc_a, args.stretch)
    synthesize(stretched, ["stretched.wav"], params=params)
    print(f"wrote stretched.wav (x{args.stretch})")


if __name__ == "__main__":
    main()
