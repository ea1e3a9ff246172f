"""Baseline spectral-AE training CLI (counterpart of
audio_style_transfer_tpu/cli/baseline_train.py; reference
nsynth/baseline/train.py:29-96).

The reference trained this model with asynchronous parameter-server
workers; this CLI runs the same model and loss synchronously on one
device. The same flags as the JAX CLI, plus ``--device`` (default ``cuda``):

    python -m audio_style_transfer_tpu_torch.cli.baseline_train \
        --train_path nsynth-train.tfrecord --logdir /tmp/nsynth_baseline

Checkpoints are ``torch.save`` files ``<logdir>/ckpt-<step>`` ({"model":
state_dict, "opt": Adam's state_dict, "step"}), written under a temporary
name and renamed; metrics go to ``<logdir>/metrics.jsonl``. The JAX CLI's
``enable_compile_cache`` call has no counterpart: nothing is compiled ahead
of the first step.
"""

from __future__ import annotations

import argparse
import os
import time


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--train_path", default="", help="Path to the train tfrecord.")
    p.add_argument("--logdir", default="/tmp/nsynth_baseline")
    p.add_argument("--config", default="nfft_1024", help="Config name (hparams set)")
    p.add_argument("--num_iters", type=int, default=10000)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--save_every", type=int, default=1000)
    p.add_argument("--device", default="cuda",
                   help="torch device the model trains on (cuda or cpu)")
    return p


def save_checkpoint(logdir: str, model, opt, step: int) -> str:
    """``<logdir>/ckpt-<step>``, written under a temporary name first."""
    import torch

    path = os.path.join(os.path.abspath(logdir), f"ckpt-{step}")
    tmp = path + ".tmp"
    torch.save({"model": model.state_dict(), "opt": opt.state_dict(), "step": step}, tmp)
    os.replace(tmp, path)
    return path


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.train_path:
        raise RuntimeError("No --train_path specified.")

    import torch

    from audio_style_transfer_tpu_torch.data import NSynthDataset
    from audio_style_transfer_tpu_torch.models.baseline_ae import (
        BaselineAE,
        BaselineHParams,
        make_optimizer,
        train_step,
    )
    from audio_style_transfer_tpu_torch.utils.profiling import MetricsLogger

    device = torch.device(args.device)
    hparams = BaselineHParams(batch_size=args.batch_size)
    model = BaselineAE(hparams, seed=0).to(device)
    opt = make_optimizer(model)

    dataset = NSynthDataset(args.train_path, is_training=True)
    batches = dataset.get_baseline_batch(hparams, device=device)

    os.makedirs(args.logdir, exist_ok=True)
    step, loss, path = 0, None, None
    with MetricsLogger(args.logdir) as metrics:
        t0 = time.time()
        for batch in batches:
            if step >= args.num_iters:
                break
            spec = torch.from_numpy(batch["spectrogram"]).to(device)
            pitch = torch.from_numpy(batch["pitch"]).to(device)
            loss = train_step(model, opt, spec, pitch)
            step += 1
            if step % args.log_every == 0:
                print(f"step {step} loss {float(loss):.5f} "
                      f"({step / (time.time() - t0):.2f} steps/s)")
                metrics.log(step, loss=float(loss))
            if args.save_every and step % args.save_every == 0:
                path = save_checkpoint(args.logdir, model, opt, step)
    if loss is None:
        raise RuntimeError(f"{args.train_path} gave no batch of {args.batch_size}")
    print(f"trained {step} steps on {device}, last loss {float(loss):.5f}; "
          f"last checkpoint {path}")


if __name__ == "__main__":
    main()
