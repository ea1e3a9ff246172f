"""Three training steps of the NSynth WaveNet autoencoder in plain PyTorch
(magenta ``nsynth/wavenet/train.py``): the mean mu-law NLL of a batch,
Adam (beta1 0.9, beta2 0.999, eps from the configuration, bias-corrected) at
the learning rate of the schedule, then the EMA shadow with TF's ramp
decay_k = min(ema_decay, (1 + k) / (10 + k)), k the updates made before.

A batch is processed a few clips at a time, its gradient summed over the
blocks, so that the float32 activations fit beside nothing else.
"""

from __future__ import annotations

import torch

from portbench.reference import nsynth
from portbench.reference.lowp import EXACT


def leaves(tree) -> dict[str, torch.Tensor]:
    return {f"{layer}/{k}": tree[layer][k] for layer in sorted(tree) for k in sorted(tree[layer])}


def learning_rate(step: int, schedule: dict) -> float:
    bounds = sorted(int(b) for b in schedule)
    current = [b for b in bounds if step >= b]
    return float(schedule[str(current[-1] if current else bounds[0])])


def loss_and_grads(params, wav: torch.Tensor, cfg: dict, clips_per_block: int, q=EXACT):
    """(mean NLL, {leaf: gradient}) of a batch [B, T] of raw audio."""
    named = leaves(params)
    for p in named.values():
        p.grad = None
    total = torch.zeros((), dtype=torch.float64, device=wav.device)
    rows = wav.numel()
    for block in wav.split(clips_per_block):
        xq = nsynth.mu_law(block)
        _, encoding = nsynth.encoder(params, xq, cfg, taps=(), q=q, encoding=True)
        part = nsynth.nll_sum(nsynth.decoder_logits(params, xq, encoding, cfg, q=q), xq) / rows
        part.backward()
        total += part.detach().double()
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)) for k, p in named.items()}
    return float(total), grads


def follow(params0, batches, cfg: dict, steps: int = 3, clips_per_block: int = 4, q=EXACT):
    """Run ``steps`` steps from the weights ``params0`` over ``batches``
    [steps, B, T]. Returns the losses, the first step's gradients, the
    weights and the EMA after the last step (leaf dicts, float32)."""
    with torch.no_grad():
        params = {layer: {k: v.detach().float().clone() for k, v in e.items()}
                  for layer, e in params0.items()}
    named = leaves(params)
    for p in named.values():
        p.requires_grad_(True)
    ema = {k: p.detach().clone() for k, p in named.items()}
    m = {k: torch.zeros_like(p) for k, p in named.items()}
    v = {k: torch.zeros_like(p) for k, p in named.items()}
    b1, b2, eps = 0.9, 0.999, cfg["adam_epsilon"]
    losses, first = [], None
    with nsynth.float32_exact():
        for step in range(steps):
            loss, grads = loss_and_grads(params, batches[step], cfg, clips_per_block, q)
            losses.append(loss)
            if first is None:
                first = {k: g.detach().clone() for k, g in grads.items()}
            lr = learning_rate(step, cfg["learning_rate_schedule"])
            decay = min(cfg["ema_decay"], (1.0 + step) / (10.0 + step))
            t = step + 1
            with torch.no_grad():
                for k, p in named.items():
                    g = grads[k]
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (v[k] / (1 - b2 ** t)).sqrt_().add_(eps)
                    p.addcdiv_(m[k], denom, value=-lr / (1 - b1 ** t))
                    ema[k].mul_(decay).add_(p, alpha=1 - decay)
    return {"losses": losses, "grad1": first,
            "params": {k: p.detach() for k, p in named.items()}, "ema": ema}
