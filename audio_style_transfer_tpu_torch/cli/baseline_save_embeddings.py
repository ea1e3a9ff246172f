"""Dataset-wide baseline latent dump (counterpart of
audio_style_transfer_tpu/cli/baseline_save_embeddings.py; reference
nsynth/baseline/save_embeddings.py).

Encodes every example of a TFRecord dataset with the baseline spectral AE
in eval mode (the BN running statistics) and saves each z with its pitch as
``<key>_baseline_z.npz``. The weights are the newest ``ckpt-<step>`` that
cli/baseline_train.py wrote under ``--checkpoint_dir``, else the seed-0
init. The same flags as the JAX CLI, plus ``--device`` (default ``cuda``);
the JAX CLI's ``enable_compile_cache`` call has no counterpart.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--tfrecord_path", default="", help="Dataset to encode.")
    p.add_argument("--checkpoint_dir", default="",
                   help="Baseline train logdir with ckpt-* files.")
    p.add_argument("--savedir", default="", help="Output directory.")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_batches", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device the encoder runs on (cuda or cpu)")
    return p


def latest_checkpoint(checkpoint_dir: str) -> str:
    """The ``ckpt-<step>`` of the largest step (names whose suffix is not all
    digits, such as a save cut off before its rename, are skipped)."""
    steps = [int(d[len("ckpt-"):]) for d in os.listdir(checkpoint_dir)
             if d.startswith("ckpt-") and d[len("ckpt-"):].isdigit()]
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {checkpoint_dir}")
    return os.path.join(os.path.abspath(checkpoint_dir), f"ckpt-{max(steps)}")


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not (args.tfrecord_path and args.savedir):
        raise RuntimeError("need --tfrecord_path and --savedir")

    import torch

    from audio_style_transfer_tpu_torch.data import NSynthDataset
    from audio_style_transfer_tpu_torch.models.baseline_ae import BaselineAE, BaselineHParams

    device = torch.device(args.device)
    hparams = BaselineHParams(batch_size=args.batch_size)
    model = BaselineAE(hparams, seed=0)
    if args.checkpoint_dir:
        saved = torch.load(latest_checkpoint(args.checkpoint_dir), map_location="cpu",
                           weights_only=True)
        model.load_state_dict(saved["model"])
    model.to(device)

    os.makedirs(args.savedir, exist_ok=True)
    dataset = NSynthDataset(args.tfrecord_path, is_training=False)
    for bi, batch in enumerate(dataset.get_baseline_batch(hparams, device=device)):
        if args.max_batches and bi >= args.max_batches:
            break
        with torch.no_grad():
            z = model.encode(torch.from_numpy(batch["spectrogram"]).to(device),
                             is_training=False).cpu().numpy()
        for i in range(z.shape[0]):
            key = batch["key"][i].decode("utf-8", "ignore") or f"b{bi}_{i}"
            np.savez(os.path.join(args.savedir, f"{key}_baseline_z.npz"),
                     z=z[i], pitch=batch["pitch"][i])
        print(f"batch {bi}: saved {z.shape[0]} latents")


if __name__ == "__main__":
    main()
