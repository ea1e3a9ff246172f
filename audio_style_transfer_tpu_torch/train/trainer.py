"""WaveNet-AE training (counterpart of audio_style_transfer_tpu/train/trainer.py;
reference nsynth/wavenet/train.py:53-132).

One step is the JAX step: the loss of a batch, its gradients (the mean over
microbatches when ``TrainConfig.microbatch`` splits the batch), Adam at the
piecewise-constant learning rate of the step, then the EMA shadow with its
ramp. The step runs eagerly: the encoder trunk through the hand-written K1
(forward, 30 launches) and K2 (the cotangent at the trunk input, 30
launches) on a CUDA device, the width-512 decoder as cuBLAS products under
``torch.utils.checkpoint`` (``TrainConfig.remat``).

Data parallelism (``Trainer(mesh=parallel.make_mesh(n))``, one process per
rank): each rank takes its contiguous row block of the global batch, and the
gradients, one flat float32 buffer, and the loss are summed over the ranks
and divided by their count (JAX's ``pmean``) before Adam and the EMA, which
every rank applies alike. The state is broadcast from rank 0 when it is made
or restored, so the weights stay equal bit for bit on every rank. Unlike
JAX's, ``mesh=None`` means this process alone, not every local device.

Checkpoints are ``torch.save`` files ``<logdir>/ckpt-<step>``, written under
a temporary name and renamed, so a kill mid-save leaves no file that
``restore`` would take.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Iterator

import numpy as np
import torch
import torch.distributed as dist

from audio_style_transfer_tpu_torch.models.wavenet_ae import (
    Params,
    WaveNetAEConfig,
    decode_logits,
    encoder_extracts,
    init_params,
    nll_loss,
)
from audio_style_transfer_tpu_torch.parallel.mesh import rank_device, replicate, shard_rows
from audio_style_transfer_tpu_torch.signal.mu_law import mu_law
from audio_style_transfer_tpu_torch.train.optimizers import scheduled_step
from audio_style_transfer_tpu_torch.utils.profiling import span


def learning_rate(step: int, schedule: dict[int, float] | None = None) -> float:
    """Piecewise-constant schedule (reference model.py:13-21, train.py:88-92),
    the float32 value in force at ``step``."""
    schedule = schedule or WaveNetAEConfig.learning_rate_schedule
    boundaries = sorted(schedule)
    idx = min(max(sum(step >= b for b in boundaries) - 1, 0), len(boundaries) - 1)
    return float(np.float32(schedule[boundaries[idx]]))


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    total_batch_size: int = 32
    sample_length: int = 6144
    num_iters: int = 200000
    ema_decay: float = 0.9999
    adam_epsilon: float = 1e-8
    logdir: str = "/tmp/nsynth"
    save_every_steps: int = 1000
    log_every_steps: int = 250
    # Split the batch into microbatches and average their gradients: bounds
    # activation memory without changing the update. None = single shot.
    microbatch: int | None = None
    # Recompute each decoder block on the backward pass (WaveNetAEConfig.remat):
    # at 32 x 6144 samples the blocks' internals would need more than 80 GB.
    remat: bool = True
    # Batches per group in ``fit``: a full group runs through ``run_steps``,
    # and the next group's host->device copy overlaps it.
    steps_per_call: int = 8


# Train state is a plain dict: {params, opt_state, ema, step}. ``opt_state``
# is the torch optimizer bound to ``params`` (it holds Adam's moments);
# ``step`` is a host int, the number of updates made.
TrainState = dict


def _leaves(tree: Params) -> list[torch.Tensor]:
    """The tensors of a params dict in a fixed order (sorted layers, keys)."""
    return [tree[layer][k] for layer in sorted(tree) for k in sorted(tree[layer])]


def train_loss(params: Params, wav: torch.Tensor, cfg: WaveNetAEConfig) -> torch.Tensor:
    """``forward(params, {"wav": wav}, cfg)["loss"]``, computed keeping only
    what the loss needs: the encoder emits tap 29 alone (the encoding's
    source), and no softmax over the rows or tap list outlives the call."""
    x_quantized = mu_law(wav)
    _, encoding = encoder_extracts(params, x_quantized, cfg,
                                   needed_taps=(cfg.ae_num_layers - 1,))
    return nll_loss(decode_logits(params, x_quantized, encoding, cfg), x_quantized)


class Trainer:
    """Owns the train step and the checkpoint lifecycle, on one device or,
    with ``mesh`` (a 1-D ``parallel.make_mesh``), on this rank's device of a
    data-parallel mesh (``device`` is then not read)."""

    def __init__(
        self,
        cfg: TrainConfig | None = None,
        model_cfg: WaveNetAEConfig | None = None,
        mesh=None,
        rng: torch.Generator | None = None,
        device: torch.device | str = "cuda",
    ):
        self.cfg = cfg or TrainConfig()
        self.model_cfg = model_cfg or WaveNetAEConfig()
        if self.cfg.remat and not self.model_cfg.remat:
            self.model_cfg = dataclasses.replace(self.model_cfg, remat=True)
        self.mesh = mesh
        self.rank = 0
        if mesh is None:
            self.device = torch.device(device)
        else:
            self.axis = mesh.mesh_dim_names[0]
            self._group = mesh.get_group(self.axis)
            self._n = mesh.size(0)
            if self.cfg.total_batch_size % self._n:
                raise ValueError(f"total_batch_size {self.cfg.total_batch_size} does not split "
                                 f"over the {self._n} ranks of the mesh")
            self.rank = mesh.get_local_rank(self.axis)
            self.device = rank_device(mesh)
        rng = rng if rng is not None else torch.Generator().manual_seed(0)
        # Every init_state() draws the same weights, as the JAX key does.
        self._rng_state = rng.get_state()
        self._copy_stream = None

    # ------------------------------------------------------------------ #

    def _optimizer(self, leaves: list[torch.Tensor]) -> torch.optim.Optimizer:
        return torch.optim.Adam(leaves, lr=learning_rate(0), betas=(0.9, 0.999),
                                eps=self.cfg.adam_epsilon)

    def _state(self, params: Params, ema: Params, step: int) -> TrainState:
        for p in _leaves(params):
            p.requires_grad_(True)
        return dict(params=params, opt_state=self._optimizer(_leaves(params)), ema=ema,
                    step=step)

    def init_state(self, params: Params | None = None) -> TrainState:
        """Fresh state: ``params`` (copied onto the device as float32) or
        ``init_params`` from the trainer's generator, Adam's zero moments, the
        EMA shadow as a copy of the params, step 0."""
        if params is None:
            gen = torch.Generator()
            gen.set_state(self._rng_state)
            params = init_params(gen, self.model_cfg)
        params = {layer: {k: v.detach().to(self.device, torch.float32).clone()
                          for k, v in e.items()} for layer, e in params.items()}
        if self.mesh is not None:
            replicate(self.mesh, _leaves(params), self.axis)
        ema = {layer: {k: v.clone() for k, v in e.items()} for layer, e in params.items()}
        return self._state(params, ema, 0)

    def _value_and_grads(self, params: Params, wav: torch.Tensor) -> torch.Tensor:
        """The loss of the batch; the gradients land in each param's .grad
        (zeros for a weight the loss does not reach: the last decoder block's
        ``res``, as JAX's gradient holds them). With microbatches: the mean of
        their losses and of their gradients."""
        leaves = _leaves(params)
        for p in leaves:
            p.grad = None
        mb = self.cfg.microbatch
        if not mb or wav.shape[0] <= mb:
            n, loss = 1, train_loss(params, wav, self.model_cfg)
            loss.backward()
            loss = loss.detach()
        else:
            if wav.shape[0] % mb:
                raise ValueError(f"batch {wav.shape[0]} is no multiple of microbatch {mb}")
            n = wav.shape[0] // mb
            loss_sum = torch.zeros((), dtype=torch.float32, device=wav.device)
            for w in wav.reshape(n, mb, *wav.shape[1:]):
                part = train_loss(params, w, self.model_cfg)
                part.backward()
                loss_sum = loss_sum + part.detach()
            loss = loss_sum / n
        for p in leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if n > 1:
            torch._foreach_div_([p.grad for p in leaves], float(n))
        if self.mesh is not None:
            loss = self._mean_over_ranks(loss, leaves)
        return loss

    def _mean_over_ranks(self, loss: torch.Tensor, leaves: list[torch.Tensor]) -> torch.Tensor:
        """JAX's ``pmean`` of the loss and the gradients: one all-reduce (sum)
        of one flat float32 buffer that holds every gradient and the loss,
        then a division by the rank count. Each .grad becomes a view of it."""
        flat = torch.cat([p.grad.reshape(-1) for p in leaves] + [loss.reshape(1)])
        dist.all_reduce(flat, group=self._group)
        flat.div_(self._n)
        offset = 0
        for p in leaves:
            p.grad = flat[offset:offset + p.numel()].view_as(p)
            offset += p.numel()
        return flat[offset]

    def _update(self, state: TrainState, wav: torch.Tensor) -> torch.Tensor:
        params = state["params"]
        loss = self._value_and_grads(params, wav)
        step = state["step"]
        opt = state["opt_state"]
        with span("adam and ema"):
            scheduled_step(opt, learning_rate, step)
            # TF-style EMA with the num_updates ramp (tf.train.ExponentialMovingAverage,
            # train.py:101-102), in float32 as the JAX step computes it.
            decay = np.minimum(np.float32(self.cfg.ema_decay),
                               np.float32(1.0 + step) / np.float32(10.0 + step))
            with torch.no_grad():
                ema = _leaves(state["ema"])
                torch._foreach_mul_(ema, float(decay))
                torch._foreach_add_(ema, _leaves(params), alpha=float(np.float32(1.0) - decay))
        state["step"] = step + 1
        return loss

    def _batch(self, wav, dim: int = 0) -> torch.Tensor:
        """The batch on the device; with a mesh, this rank's rows of the
        global batch along ``dim``."""
        if self.mesh is not None:
            wav = shard_rows(self.mesh, wav, self.axis, dim)
        if isinstance(wav, torch.Tensor):
            return wav.to(self.device, torch.float32)
        return torch.from_numpy(np.asarray(wav, np.float32)).to(self.device)

    def step(self, state: TrainState, wav) -> tuple[TrainState, torch.Tensor]:
        """One step on the global batch ``wav`` [B, T] (numpy or tensor).
        Updates ``state`` in place and returns it with the loss (a device
        scalar, the mean over the ranks)."""
        return state, self._update(state, self._batch(wav))

    def run_steps(self, state: TrainState, wavs) -> tuple[TrainState, torch.Tensor]:
        """K steps over ``wavs`` [K, B, T]: (state, losses [K] on the device;
        nothing is read back)."""
        wavs = self._batch(wavs, dim=1)
        losses = [self._update(state, w) for w in wavs]
        return state, torch.stack(losses)

    # ------------------------------------------------------------------ #
    # Evaluation under the EMA shadow weights (the reference evaluates the
    # EMA'd variables, nsynth/wavenet/train.py:101-102).
    # ------------------------------------------------------------------ #

    def eval_params(self, state: TrainState, ema: bool = True) -> Params:
        """The weights evaluation/serving should use (EMA shadow by default)."""
        return state["ema"] if ema else state["params"]

    def evaluate(self, state: TrainState, wav, ema: bool = True) -> float:
        """Mean NLL of a batch under the eval weights, without a graph (the
        trunk's gradient-free pass: K1 only)."""
        with torch.no_grad():
            return float(train_loss(self.eval_params(state, ema=ema), self._batch(wav),
                                    self.model_cfg))

    # ------------------------------------------------------------------ #

    def _upload(self, group: list) -> torch.Tensor:
        """Start the copy of a group of host batches [K, B, T] to the device:
        from pinned memory on a side stream, so it overlaps the step running
        on the compute stream (``_ready`` orders them). With a mesh, only
        this rank's rows."""
        host = np.stack(group).astype(np.float32, copy=False)
        if self.mesh is not None:
            host = shard_rows(self.mesh, host, self.axis, dim=1)
        host = torch.from_numpy(np.ascontiguousarray(host))
        if self.device.type != "cuda":
            return host.to(self.device)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        host = host.pin_memory()
        with torch.cuda.stream(self._copy_stream):
            return host.to(self.device, non_blocking=True)

    def _ready(self, group: torch.Tensor) -> torch.Tensor:
        if group.is_cuda:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_stream(self._copy_stream)
            group.record_stream(compute)
        return group

    def fit(
        self,
        state: TrainState,
        batches: Iterator[dict],
        num_steps: int | None = None,
        log=print,
    ) -> TrainState:
        """Training loop with periodic checkpoints and preemption safety.

        Batches come in groups of ``steps_per_call`` (the last one may be
        partial), each group copied to the device while the previous one
        runs. The step counter lives on the host: the loop reads a device
        value only at log steps. A SIGTERM/SIGINT ends the loop after the
        running group with a checkpoint.

        With a mesh every rank reads the same global stream and uploads its
        own rows; the preemption flag is reduced (max) over the ranks after
        each group, so all of them stop together; rank 0 alone logs and
        writes checkpoints.
        """
        cfg = self.cfg
        num_steps = num_steps or cfg.num_iters
        t0 = time.time()
        interrupted = {"flag": False}

        def _handler(signum, frame):
            interrupted["flag"] = True

        prev_term = signal.signal(signal.SIGTERM, _handler)
        prev_int = signal.signal(signal.SIGINT, _handler)
        k = max(1, cfg.steps_per_call)
        step = int(state["step"])
        step_start = step
        try:
            done = False
            it = iter(batches)
            remaining = num_steps

            def next_group(n):
                nonlocal done
                group = []
                for _ in range(n):
                    try:
                        group.append(next(it)["wav"])
                    except StopIteration:
                        done = True
                        break
                return self._upload(group) if group else None

            pending = next_group(min(k, remaining))
            while remaining > 0 and pending is not None:
                group = self._ready(pending)
                n_in_group = group.shape[0]
                for wav in group:
                    loss = self._update(state, wav)
                # The steps are queued on the device; read and copy the next
                # group meanwhile.
                pending = (
                    next_group(min(k, remaining - n_in_group))
                    if remaining - n_in_group > 0 and not done
                    else None
                )
                remaining -= n_in_group
                step += n_in_group
                if self.rank == 0 and step % cfg.log_every_steps < n_in_group:
                    log(
                        f"step {step} loss {float(loss):.4f} "
                        f"({(step - step_start) / (time.time() - t0):.2f}"
                        " steps/s)"
                    )
                if cfg.save_every_steps and step % cfg.save_every_steps < n_in_group:
                    self.save(state)
                if self._any_rank(interrupted["flag"]):
                    if self.rank == 0:
                        log(f"preemption signal at step {step}: checkpointing")
                    self.save(state)
                    break
        finally:
            signal.signal(signal.SIGTERM, prev_term)
            signal.signal(signal.SIGINT, prev_int)
        return state

    def _any_rank(self, flag: bool) -> bool:
        """``flag`` or-ed over the ranks of the mesh (an all-reduce max)."""
        if self.mesh is None:
            return flag
        t = torch.tensor([float(flag)], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._group)
        return bool(t.item())

    # ------------------------------------------------------------------ #
    # Checkpointing (reference ckpt cadence: train.py:130; resume semantics
    # of slim.learning.train's supervisor).
    # ------------------------------------------------------------------ #

    def _ckpt_path(self, step: int) -> str:
        return os.path.join(os.path.abspath(self.cfg.logdir), f"ckpt-{step}")

    def save(self, state: TrainState) -> str:
        """Write ``<logdir>/ckpt-<step>``: params, the optimizer's state_dict,
        EMA and step, under a temporary name, then renamed into place. With a
        mesh, rank 0 writes and every rank waits for it at a barrier."""
        path = self._ckpt_path(int(state["step"]))
        if self.rank == 0:
            self._write(state, path)
        if self.mesh is not None:
            dist.barrier(group=self._group)
        return path

    def _write(self, state: TrainState, path: str) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        detach = lambda tree: {layer: {k: v.detach() for k, v in e.items()}  # noqa: E731
                               for layer, e in tree.items()}
        payload = dict(params=detach(state["params"]), opt_state=state["opt_state"].state_dict(),
                       ema=detach(state["ema"]), step=int(state["step"]))
        tmp = f"{path}.tmp-{os.getpid()}"
        torch.save(payload, tmp)
        os.replace(tmp, path)

    def restore(self, step: int | None = None) -> TrainState:
        """The state saved at ``step``, or at the largest step saved. Only
        complete checkpoints count: names whose suffix is not all digits
        (a save cut off before its rename) are skipped. With a mesh every
        rank reads the checkpoint (the logdir is shared), then the params,
        EMA and Adam's moments are broadcast from rank 0."""
        logdir = os.path.abspath(self.cfg.logdir)
        if step is None:
            steps = [
                int(d[len("ckpt-"):])
                for d in os.listdir(logdir)
                if d.startswith("ckpt-") and d[len("ckpt-"):].isdigit()
            ]
            if not steps:
                raise FileNotFoundError(f"no checkpoints under {logdir}")
            step = max(steps)
        saved = torch.load(self._ckpt_path(step), map_location="cpu", weights_only=True)
        on_device = lambda tree: {layer: {k: v.to(self.device) for k, v in e.items()}  # noqa: E731
                                  for layer, e in tree.items()}
        state = self._state(on_device(saved["params"]), on_device(saved["ema"]),
                            int(saved["step"]))
        state["opt_state"].load_state_dict(saved["opt_state"])
        if self.mesh is not None:
            moments = [v for p in _leaves(state["params"])
                       for key, v in sorted(state["opt_state"].state[p].items())
                       if key != "step"]
            replicate(self.mesh, _leaves(state["params"]) + _leaves(state["ema"]) + moments,
                      self.axis)
        return state
