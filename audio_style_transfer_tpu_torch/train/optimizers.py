"""Optimizer factory (reference nsynth/utils.py:178-203 ``get_optimizer``;
counterpart of audio_style_transfer_tpu/train/optimizers.py).

The five names map to update rules equal to optax's, which the JAX package
uses, with its hyperparameters (rmsprop decay 0.95 / eps 1e-4, adam beta1
0.9 / beta2 0.999 / eps 1e-8, adagrad initial accumulator 1.0, momentum
from ``hparams``). Where a ``torch.optim`` class computes optax's rule it is
used: ``optax.adam`` is ``torch.optim.Adam`` (the same bias correction in
exact arithmetic), ``optax.sgd`` with or without momentum is
``torch.optim.SGD`` (optax's trace starts at zero, torch's buffer at the
first gradient: the same values). RMSprop and Adagrad are not: optax puts
eps inside the square root and starts Adagrad's accumulator at the given
value, so both rules are written here.

A learning rate is a float or a schedule ``count -> float``, read at optax's
``count``: the number of updates made before this one
(``scheduled_step``).
"""

from __future__ import annotations

import torch


class OptaxRMSprop(torch.optim.Optimizer):
    """optax.rmsprop (centered=False, eps_in_sqrt=True, initial_scale 0):
    nu = decay * nu + (1 - decay) g^2; u = -lr g / sqrt(nu + eps); with
    momentum, t = u + momentum * t (optax.trace after the learning rate) and
    the update is t."""

    def __init__(self, params, lr, decay: float = 0.9, eps: float = 1e-8,
                 momentum: float | None = None):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps, momentum=momentum))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr, decay, eps, mom = group["lr"], group["decay"], group["eps"], group["momentum"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["nu"] = torch.zeros_like(p)
                    if mom is not None:
                        st["trace"] = torch.zeros_like(p)
                g = p.grad
                nu = st["nu"].mul_(decay).addcmul_(g, g, value=1.0 - decay)
                u = g * torch.rsqrt(nu + eps) * -lr
                if mom is not None:
                    u = st["trace"].mul_(mom).add_(u)
                p.add_(u)


class OptaxAdagrad(torch.optim.Optimizer):
    """optax.adagrad: s = s + g^2 from ``initial_accumulator_value``;
    u = -lr g / sqrt(s + eps) where s > 0, else 0."""

    def __init__(self, params, lr, initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7):
        super().__init__(params, dict(lr=lr, initial_accumulator_value=initial_accumulator_value,
                                      eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["sum_of_squares"] = torch.full_like(p, group["initial_accumulator_value"])
                g = p.grad
                s = st["sum_of_squares"].addcmul_(g, g)
                scale = torch.where(s > 0, torch.rsqrt(s + group["eps"]), torch.zeros_like(s))
                p.add_(scale * g * -group["lr"])


def _lr_at(learning_rate, count: int) -> float:
    return float(learning_rate(count)) if callable(learning_rate) else float(learning_rate)


def get_optimizer(params, learning_rate, hparams=None, name: str | None = None):
    """Build a torch optimizer over ``params`` (an iterable of tensors) by name.

    Args:
      learning_rate: float or schedule ``count -> float``; the optimizer
        starts at its value for count 0 (see ``scheduled_step``).
      hparams: object with ``optimizer`` and ``momentum`` attributes (the
        reference's HParams shape), or None when ``name`` is given.
      name: direct optimizer name overriding hparams.
    """
    momentum = getattr(hparams, "momentum", 0.9)
    name = name or getattr(hparams, "optimizer", "adam")
    lr = _lr_at(learning_rate, 0)
    table = {
        "rmsprop": lambda: OptaxRMSprop(params, lr, decay=0.95, eps=1e-4, momentum=momentum),
        "adam": lambda: torch.optim.Adam(params, lr, betas=(0.9, 0.999), eps=1e-8),
        "adagrad": lambda: OptaxAdagrad(params, lr, initial_accumulator_value=1.0),
        "mom": lambda: torch.optim.SGD(params, lr, momentum=momentum),
        "sgd": lambda: torch.optim.SGD(params, lr),
    }
    if name not in table:
        raise KeyError(f"unknown optimizer {name!r}; options: {sorted(table)}")
    return table[name]()


def scheduled_step(optimizer: torch.optim.Optimizer, learning_rate, count: int) -> None:
    """One update at the learning rate of ``count`` (optax's count: the
    updates made before this one), from the gradients in ``p.grad``."""
    lr = _lr_at(learning_rate, count)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
