"""Mu-law codecs (counterpart of audio_style_transfer_tpu/signal/mu_law.py).

``mu_law_numpy``/``inv_mu_law_numpy`` are the host-side floor-quantizing
encoder and decoder (reference utils.py:79-90); ``mu_law_quantize`` is the
same floor-quantizing encoder on tensors; ``mu_law``/``inv_mu_law`` work on
tensors, the former continuous (no floor), the latter gradient-safe at 0
(reference utils.py:92-104).
"""

from __future__ import annotations

import numpy as np
import torch

_MU = 255.0


def mu_law_numpy(x, mu: float = _MU):
    """Floor-quantizing mu-law encode (host/numpy), floats in [-128, 128]."""
    x = np.asarray(x)
    out = np.sign(x) * np.log1p(mu * np.abs(x)) / np.log1p(mu)
    return np.floor(out * 128.0)


def inv_mu_law_numpy(x, mu: float = _MU):
    """Host/numpy inverse mu-law (reference utils.py:85-90)."""
    x = np.asarray(x).astype(np.float32)
    out = (x + 0.5) * 2.0 / (mu + 1.0)
    out = np.sign(out) / mu * ((1.0 + mu) ** np.abs(out) - 1.0)
    return np.where(x == 0, x, out)


def mu_law_quantize(x: torch.Tensor, mu: float = _MU) -> torch.Tensor:
    """Floor-quantizing mu-law encode on tensors. Same math as mu_law_numpy."""
    out = torch.sign(x) * torch.log1p(mu * torch.abs(x)) / np.log1p(mu)
    return torch.floor(out * 128.0)


def mu_law(x: torch.Tensor, mu: float = _MU) -> torch.Tensor:
    """Continuous (differentiable) mu-law encode, no floor."""
    return torch.sign(x) * torch.log1p(mu * torch.abs(x)) / np.log1p(mu) * 128.0


def safe_abs(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Gradient-safe |x|: ``max(x, eps) + max(0, -x)``."""
    return torch.clamp(x, min=eps) + torch.clamp(-x, min=0.0)


def safe_sign(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Gradient-safe sign: 0 inside |x| <= eps."""
    out = torch.where(torch.abs(x) <= eps, torch.zeros_like(x), x)
    return out / safe_abs(x, eps)


def inv_mu_law(x: torch.Tensor, mu: float = _MU) -> torch.Tensor:
    """Gradient-safe inverse mu-law on quantized-space values."""
    x = x.to(torch.float32)
    out = (x + 0.5) * 2.0 / (mu + 1.0)
    out = safe_sign(out) / mu * ((1.0 + mu) ** safe_abs(out) - 1.0)
    return torch.where(x == 0, x, out)
