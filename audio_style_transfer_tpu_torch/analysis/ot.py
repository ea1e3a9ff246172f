"""Optimal transport between NMF palettes via ADMM (counterpart of
audio_style_transfer_tpu/analysis/ot.py; reference optimal_transport.py:
22-162: cost matrix, the projections, the rho=1e2 ADMM loop, the palette
transform).

Palettes are [n_components, n_features] and rows are transported. Every
function also takes a stack of problems with leading dimensions, where the
JAX package uses ``vmap``: each problem stops on its own convergence test and
is frozen from then on, so a stacked solve equals the problems solved one by
one. The loop is eager; the stop test is read from the device every
``_CHECK_EVERY`` iterations (a frozen problem does not move in between).
"""

from __future__ import annotations

import numpy as np
import torch

_F32 = torch.float32
_CHECK_EVERY = 32


def build_moving_cost_matrix(palette1, palette2) -> torch.Tensor:
    """Pairwise Euclidean cost (reference optimal_transport.py:22-37)."""
    p1 = torch.as_tensor(palette1, dtype=_F32)
    p2 = torch.as_tensor(palette2, dtype=_F32, device=p1.device)
    sq = torch.sum((p1[..., :, None, :] - p2[..., None, :, :]) ** 2, dim=-1)
    return torch.sqrt(sq)


def projection_sum_equal(x0, target_value: float):
    """min ||X - X0|| s.t. sum(X) = target (reference :40-47)."""
    size = x0.shape[-2] * x0.shape[-1]
    corr = (target_value - torch.sum(x0, dim=(-2, -1), keepdim=True)) / size
    return x0 + corr


def projection_column_sum_in_range(x0, lo, hi):
    """min ||X - X0|| s.t. lo_i <= sum(X, -1)_i <= hi_i (reference :50-74)."""
    ref = torch.sum(x0, dim=-1)
    zero = torch.zeros_like(ref)
    corr = torch.where(ref < lo, lo - ref, zero) + torch.where(ref > hi, hi - ref, zero)
    return x0 + (corr / x0.shape[-1])[..., None]


def _fro(a):
    return torch.sqrt(torch.sum(torch.square(a), dim=(-2, -1)))


@torch.no_grad()
def ot_admm(palette2mod, palette_ref, eps: float = 1e-4, miter: int = 100000,
            return_info: bool = False):
    """ADMM optimal transport (reference optimal_transport.py:77-137).

    Returns the transport plan [..., n1, n2]; with ``return_info`` also a
    dict of convergence diagnostics per problem (iterations run, converged,
    final residual norms)."""
    c = build_moving_cost_matrix(palette2mod, palette_ref)
    c = c / torch.amax(c, dim=(-2, -1), keepdim=True)
    lead, (n1, n2) = tuple(c.shape[:-2]), c.shape[-2:]
    dev = c.device
    # Row / column masses lie in [0, 1 / size] (reference :86-89).
    lo1, hi1 = torch.zeros(n1, device=dev), torch.full((n1,), 1.0 / n1, device=dev)
    lo2, hi2 = torch.zeros(n2, device=dev), torch.full((n2,), 1.0 / n2, device=dev)
    rho = 1e2

    sol = torch.zeros_like(c)
    aux = torch.zeros((3,) + tuple(c.shape), device=dev)
    lam = torch.zeros_like(aux)
    res = torch.zeros((4,) + lead, device=dev)
    it = torch.zeros(lead, dtype=torch.int32, device=dev)
    done = torch.zeros(lead, dtype=torch.bool, device=dev)

    steps = 0
    while True:
        active = ~done & (it <= miter)
        if steps % _CHECK_EVERY == 0 and not bool(active.any()):
            break
        steps += 1
        new = (-c + rho * torch.sum(aux, 0) + torch.sum(lam, 0)) / (3.0 * rho)
        new = torch.clamp(new, min=0.0)
        shifted = new[None] - lam / rho
        new_aux = torch.stack([
            projection_column_sum_in_range(shifted[0], lo1, hi1),
            projection_column_sum_in_range(shifted[1].mT, lo2, hi2).mT,
            projection_sum_equal(shifted[2], 1.0),
        ])
        new_lam = lam + rho * (new_aux - new[None])
        new_res = torch.stack([_fro(new - sol), _fro(new - new_aux[0]),
                               _fro(new - new_aux[1]), _fro(new - new_aux[2])])
        converged = torch.all(new_res < eps * _fro(new), dim=0)
        m2 = active[..., None, None]
        sol = torch.where(m2, new, sol)
        aux = torch.where(m2, new_aux, aux)
        lam = torch.where(m2, new_lam, lam)
        res = torch.where(active, new_res, res)
        done = torch.where(active, converged, done)
        it = it + active.to(it.dtype)

    if return_info:
        return sol, dict(iterations=it, converged=done, d_change=res[0], d_aux=res[1:])
    return sol


def transform_palette(palette_orig, palette_target, transport) -> torch.Tensor:
    """Barycentric projection (reference optimal_transport.py:140-148)."""
    transport = torch.as_tensor(transport, dtype=_F32)
    target = torch.as_tensor(palette_target, dtype=_F32, device=transport.device)
    sum_gamma = torch.sum(transport, dim=-1)
    return (transport @ target) / (sum_gamma + 1e-10)[..., None]


def compute_permutation(w1, w2, verbose: bool = False) -> np.ndarray:
    """Transform W2 to match W1 via OT (reference optimal_transport.py:151-162):
    an array with W1's row count in W2's feature space. ``verbose`` prints the
    solver's convergence diagnostics after the solve."""
    w1, w2 = torch.as_tensor(w1, dtype=_F32), torch.as_tensor(w2, dtype=_F32)
    plan, info = ot_admm(w1, w2, return_info=True)
    if verbose:
        print(f"OT ADMM: {int(info['iterations'])} iterations, "
              f"converged={bool(info['converged'])}, "
              f"d_change={float(info['d_change']):.3e}, "
              f"d_aux={[f'{float(v):.3e}' for v in info['d_aux']]}")
    return transform_palette(w1, w2, plan).cpu().numpy()
