"""Non-negative matrix factorization with multiplicative updates (counterpart
of audio_style_transfer_tpu/analysis/nmf.py).

Replaces the sklearn NMF the reference calls inside its feature transform
(reference utils.py:132-145: ``non_negative_factorization(enc, H=ws.T,
update_H=False, solver='mu', max_iter=400)``). Every function takes one
problem ([n, f]) or a stack of them with leading dimensions ([..., n, f]),
where the JAX package uses ``vmap``; the updates are plain matrix products
on the tensors' device.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = float(np.finfo(np.float32).eps)
_F32 = torch.float32


def _mu_update_w(x, w, h):
    """One Frobenius multiplicative update of W in X ~ W @ H."""
    numer = x @ h.mT
    denom = w @ (h @ h.mT)
    return w * numer / torch.clamp(denom, min=_EPS)


def _mu_update_h(x, w, h):
    numer = w.mT @ x
    denom = (w.mT @ w) @ h
    return h * numer / torch.clamp(denom, min=_EPS)


def _init_scale(x, n_components: int):
    """sqrt(mean(X) / n_components) per problem, shaped to broadcast."""
    return torch.sqrt(torch.mean(x, dim=(-2, -1), keepdim=True) / n_components)


@torch.no_grad()
def nmf_transform(x, h, max_iter: int = 400) -> torch.Tensor:
    """Solve min_W ||X - W H||_F with W >= 0 and H fixed (solver='mu'), as
    sklearn's transform-only call at reference utils.py:134-135.

    x [..., n_samples, n_features] non-negative data, h [..., n_components,
    n_features] the fixed dictionary; returns w [..., n_samples, n_components]."""
    x = torch.as_tensor(x, dtype=_F32)
    h = torch.as_tensor(h, dtype=_F32, device=x.device)
    k = h.shape[-2]
    # sklearn initializes W for a custom-H transform with sqrt(mean / k).
    w = _init_scale(x, k).expand(*x.shape[:-1], k).contiguous()
    for _ in range(max_iter):
        w = _mu_update_w(x, w, h)
    return w


@torch.no_grad()
def nmf(x, n_components: int, max_iter: int = 200,
        generator: torch.Generator | None = None, init=None):
    """Full alternating multiplicative-update NMF: X ~ W @ H.

    The initial factors are ``init = (w0, h0)`` when given, else
    sqrt(mean(X) / k) * |N(0, 1)| drawn on the CPU from ``generator`` (seed 0
    when None; the JAX keys are not reproduced bit for bit).
    Returns (w [..., n, k], h [..., k, f])."""
    x = torch.as_tensor(x, dtype=_F32)
    n, f = x.shape[-2:]
    if init is not None:
        w, h = (torch.as_tensor(a, dtype=_F32, device=x.device) for a in init)
    else:
        gen = generator or torch.Generator().manual_seed(0)
        avg = _init_scale(x, n_components)
        lead = tuple(x.shape[:-2])
        w = avg * torch.randn(lead + (n, n_components), generator=gen).abs().to(x.device)
        h = avg * torch.randn(lead + (n_components, f), generator=gen).abs().to(x.device)
    for _ in range(max_iter):
        w = _mu_update_w(x, w, h)
        h = _mu_update_h(x, w, h)
    return w, h


def transform(enc, ws, wt, n_components: int, figdir: str | None = None):
    """The reference's NMF + optimal-transport feature transform (reference
    utils.py:132-145): project ``enc`` onto the source palette ``ws``,
    permute the palette toward ``wt`` with OT, and reconstruct.

    enc [1, T, C] non-negative features, ws/wt [k, C] source / target NMF
    palettes; returns [1, T, C] as numpy."""
    from audio_style_transfer_tpu_torch.analysis.ot import compute_permutation

    enc2d = np.asarray(enc, np.float32)[0]
    ws, wt = np.asarray(ws, np.float32), np.asarray(wt, np.float32)
    h_t = nmf_transform(torch.as_tensor(enc2d), torch.as_tensor(ws)).numpy()  # [T, k]
    wt_matched = compute_permutation(ws, wt)

    if figdir is not None:
        from audio_style_transfer_tpu_torch.analysis.viz import compare_2_matrix

        compare_2_matrix(ws, wt_matched, figdir)

    u = h_t @ ws
    err = np.linalg.norm(enc2d - u) / np.linalg.norm(enc2d)
    diff = np.linalg.norm(ws - wt_matched) / np.linalg.norm(ws)
    print(f" Error for ws * h_ = enc: {err}")
    print(f" difference between two matrices {diff}")
    return u[None, ...]
