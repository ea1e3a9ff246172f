"""Batch generation CLI (counterpart of audio_style_transfer_tpu/cli/generate.py,
mirror of reference nsynth_generate.py:24-102).

Given a directory of .wav files (encoded first) or precomputed .npy
encodings, synthesize audio with the incremental decoder (one CUDA-graphed
step per sample on the card). The same flags as the JAX CLI, plus
``--device`` (default ``cuda``):

    python -m audio_style_transfer_tpu_torch.cli.generate \
        --source_path dir/ --save_path out/ --checkpoint_path ckpt.npz
"""

from __future__ import annotations

import argparse
import os


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--source_path", default="", help="Path to directory with "
                   "either .wav files or precomputed encodings in .npy files.")
    p.add_argument("--npy_only", action="store_true",
                   help="If set, use only .npy files.")
    p.add_argument("--save_path", default="", help="Path to output file dir.")
    p.add_argument("--checkpoint_path", default="model.ckpt-200000",
                   help="Path to checkpoint.")
    p.add_argument("--sample_length", type=int, default=100000000,
                   help="Max output file size in samples.")
    p.add_argument("--batch_size", type=int, default=1,
                   help="Number of samples per a batch.")
    p.add_argument("--log", default="INFO")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 decoder weights (f32 activations)")
    p.add_argument("--int8", action="store_true",
                   help="int8 decoder weights (per-channel scales; mutually "
                        "exclusive with --bf16)")
    p.add_argument("--device", default="cuda",
                   help="torch device the encoder and decoder run on (cuda or cpu)")
    return p


def discover_files(source_path: str, npy_only: bool = False):
    """File discovery logic of reference nsynth_generate.py:52-71."""
    if os.path.isdir(source_path):
        files = os.listdir(source_path)
        exts = [os.path.splitext(f)[1] for f in files]
        if ".wav" in exts:
            postfix = ".wav"
        elif ".npy" in exts:
            postfix = ".npy"
        else:
            raise RuntimeError("Folder must contain .wav or .npy files.")
        postfix = ".npy" if npy_only else postfix
        return sorted(
            os.path.join(source_path, fname)
            for fname in files
            if fname.lower().endswith(postfix)
        ), postfix
    if source_path.lower().endswith((".wav", ".npy")):
        return [source_path], os.path.splitext(source_path)[1]
    return [], ""


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.save_path:
        raise RuntimeError("Must specify a save_path.")
    if args.bf16 and args.int8:
        parser.error("--bf16 and --int8 are mutually exclusive "
                     "(int8 fixes the decoder weight storage format itself)")

    import torch

    from audio_style_transfer_tpu_torch.ckpt.convert import load_pretrained
    from audio_style_transfer_tpu_torch.generate import encode, load_batch, synthesize

    files, postfix = discover_files(args.source_path, args.npy_only)
    params = load_pretrained(args.checkpoint_path, device=args.device)
    os.makedirs(args.save_path, exist_ok=True)

    for start in range(0, len(files), args.batch_size):
        batch_files = files[start : start + args.batch_size]
        save_names = [
            os.path.join(
                args.save_path,
                "gen_" + os.path.splitext(os.path.basename(f))[0] + ".wav",
            )
            for f in batch_files
        ]
        batch_data = load_batch(batch_files, sample_length=args.sample_length)
        encodings = (
            batch_data
            if postfix == ".npy"
            else encode(batch_data, params, sample_length=args.sample_length)
        )
        synthesize(encodings, save_names, params=params, seed=args.seed,
                   dtype=torch.bfloat16 if args.bf16 else None,
                   quantize="int8" if args.int8 else None)
        print(f"generated {len(save_names)} file(s): {save_names}")


if __name__ == "__main__":
    main()
