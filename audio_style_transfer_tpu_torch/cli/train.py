"""WaveNet-AE training CLI (counterpart of audio_style_transfer_tpu/cli/train.py,
mirror of reference nsynth/wavenet/train.py:32-50).

The same flags as the JAX CLI, plus ``--device`` (default ``cuda``). One
device: ``--num_devices`` above 1 (data parallelism) is ROADMAP.md M8.

    python -m audio_style_transfer_tpu_torch.cli.train \
        --train_path data.tfrecord --logdir /tmp/nsynth --total_batch_size 32
"""

from __future__ import annotations

import argparse


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default="model", help="Model configuration name")
    p.add_argument("--total_batch_size", type=int, default=1,
                   help="Batch size spread across all replicas. We use 32.")
    p.add_argument("--logdir", default="/tmp/nsynth",
                   help="The log directory for this experiment.")
    p.add_argument("--train_path", default="",
                   help="The path to the train tfrecord.")
    p.add_argument("--log", default="INFO")
    p.add_argument("--num_iters", type=int, default=200000)
    p.add_argument("--num_devices", type=int, default=None,
                   help="Devices in the data-parallel mesh (one until M8).")
    p.add_argument("--sample_length", type=int, default=6144)
    p.add_argument("--resume", action="store_true",
                   help="Resume from the latest checkpoint in logdir.")
    p.add_argument("--device", default="cuda",
                   help="torch device the model trains on (cuda or cpu)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.train_path:
        raise RuntimeError("No --train_path specified.")
    if args.num_devices is not None and args.num_devices > 1:
        raise NotImplementedError(
            f"--num_devices {args.num_devices}: data-parallel training is not ported yet "
            "(ROADMAP.md M8: multi-device, torch.distributed)")

    from audio_style_transfer_tpu_torch.data import NSynthDataset
    from audio_style_transfer_tpu_torch.ops import _build
    from audio_style_transfer_tpu_torch.train import TrainConfig, Trainer

    cfg = TrainConfig(
        total_batch_size=args.total_batch_size,
        sample_length=args.sample_length,
        num_iters=args.num_iters,
        logdir=args.logdir,
    )
    trainer = Trainer(cfg, device=args.device)
    state = trainer.restore() if args.resume else trainer.init_state()

    dataset = NSynthDataset(args.train_path, is_training=True)
    batches = dataset.get_wavenet_batch(args.total_batch_size, length=args.sample_length)
    state = trainer.fit(state, batches, num_steps=args.num_iters)
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    print(f"saved {trainer.save(state)} at step {state['step']} "
          f"({dataset.reader_used} reader); kernel launches {launches}")


if __name__ == "__main__":
    main()
