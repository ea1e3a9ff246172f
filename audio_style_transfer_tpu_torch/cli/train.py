"""WaveNet-AE training CLI (counterpart of audio_style_transfer_tpu/cli/train.py,
mirror of reference nsynth/wavenet/train.py:32-50).

The same flags as the JAX CLI, plus ``--device`` (default ``cuda``). The
parameter-server flags are superseded by data parallelism over
torch.distributed: ``--num_devices N`` trains on N ranks, each on its own
card over NCCL (``--device cpu``: N processes over gloo), the global batch
``--total_batch_size`` split between them and the gradients averaged. The
CLI starts the N workers itself, or, under a launcher, joins its world:

    python -m audio_style_transfer_tpu_torch.cli.train \
        --train_path data.tfrecord --logdir /tmp/nsynth --total_batch_size 32
    python -m audio_style_transfer_tpu_torch.cli.train --num_devices 4 ...
    torchrun --nproc_per_node 4 -m audio_style_transfer_tpu_torch.cli.train ...
"""

from __future__ import annotations

import argparse
import os


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
                   help="Ranks of the data-parallel mesh (default: one process, or the "
                        "launcher's WORLD_SIZE).")
    p.add_argument("--sample_length", type=int, default=6144)
    p.add_argument("--resume", action="store_true",
                   help="Resume from the latest checkpoint in logdir.")
    p.add_argument("--device", default="cuda",
                   help="torch device the model trains on (cuda or cpu)")
    return p


def _launched() -> bool:
    """Whether a launcher (torchrun) started this process as one rank."""
    from audio_style_transfer_tpu_torch.parallel.mesh import LAUNCHER_VARS

    return all(v in os.environ for v in LAUNCHER_VARS)


def _train(args, mesh) -> None:
    from audio_style_transfer_tpu_torch.data import NSynthDataset
    from audio_style_transfer_tpu_torch.ops import _build
    from audio_style_transfer_tpu_torch.train import TrainConfig, Trainer

    cfg = TrainConfig(
        total_batch_size=args.total_batch_size,
        sample_length=args.sample_length,
        num_iters=args.num_iters,
        logdir=args.logdir,
    )
    trainer = Trainer(cfg, mesh=mesh, device=args.device)
    state = trainer.restore() if args.resume else trainer.init_state()

    dataset = NSynthDataset(args.train_path, is_training=True)
    batches = dataset.get_wavenet_batch(args.total_batch_size, length=args.sample_length)
    state = trainer.fit(state, batches, num_steps=args.num_iters)
    path = trainer.save(state)
    if trainer.rank == 0:
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        print(f"saved {path} at step {state['step']} ({dataset.reader_used} reader); "
              f"kernel launches {launches}")


def _rank_main(rank: int, args) -> None:
    """One spawned rank: join the mesh and train."""
    from audio_style_transfer_tpu_torch.parallel import make_mesh

    _train(args, make_mesh(args.num_devices, device=args.device))


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.train_path:
        raise RuntimeError("No --train_path specified.")
    n = args.num_devices
    if _launched():
        from audio_style_transfer_tpu_torch.parallel import make_mesh

        return _train(args, make_mesh(n, device=args.device))
    if n is None or n == 1:
        return _train(args, None)
    if args.device == "cuda":
        import torch

        from audio_style_transfer_tpu_torch.ops import _build

        count = torch.cuda.device_count()
        if n > count:
            raise ValueError(f"--num_devices {n}: {count} CUDA device(s) visible, and NCCL "
                             "needs one per rank")
        _build.lib()  # build the kernels once, before the workers load them
    from audio_style_transfer_tpu_torch.parallel.mesh import spawn

    spawn(_rank_main, n, args=(args,), device=args.device)


if __name__ == "__main__":
    main()
