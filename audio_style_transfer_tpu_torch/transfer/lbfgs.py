"""L-BFGS with a strong-Wolfe zoom line search, eager (counterpart of
audio_style_transfer_tpu/transfer/lbfgs.py).

The JAX version is one XLA program of nested while loops. Here the same
state machine runs as Python loops: the iterate, the gradient and the
curvature memory stay on the iterate's device, while the scalars that steer
the control flow (f, the directional derivatives, the step) are float32
0-d tensors on the host, so the branch decisions round as the JAX float32
ones do. Each evaluation therefore synchronises with the device once or
twice; removing those syncs is later work.

Only the zoom search (the one the transfer engine runs) is ported; the
Moré-Thuente search (``line_search="mt"``, the JAX default) is not yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class LBFGSOptions:
    maxiter: int = 100
    memory: int = 10
    # SciPy L-BFGS-B defaults: factr=1e7 => ftol = 1e7 * eps(float64).
    ftol: float = 2.220446049250313e-09
    gtol: float = 1e-05
    maxls: int = 20
    # Consecutive zero-progress iterations before declaring ftol convergence.
    ftol_patience: int = 1
    # On a failed line search with non-empty history, discard the memory and
    # retry from the same point with steepest descent.
    restart_on_ls_fail: bool = True
    # "zoom" (ported) or "mt" (Moré-Thuente, not ported yet).
    line_search: str = "mt"
    c1: float | None = None
    c2: float | None = None
    xtol: float = 0.1

    def resolved_c1c2(self) -> tuple[float, float]:
        if self.line_search == "mt":
            c1d, c2d = 1e-3, 0.9
        else:
            c1d, c2d = 1e-4, 0.5
        return (self.c1 if self.c1 is not None else c1d,
                self.c2 if self.c2 is not None else c2d)


class LBFGSResult(NamedTuple):
    x: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    n_iters: int  # outer iterations completed
    n_evals: int  # value_and_grad evaluations (incl. the initial one)
    status: int  # 0 converged(gtol) 1 converged(ftol) 2 maxiter 3 ls_fail
    aux: object = None  # has_aux=True: the objective's aux at x0


def _host(v: torch.Tensor) -> torch.Tensor:
    """A float32 0-d host copy of a scalar tensor (one device sync)."""
    return v.detach().to("cpu", _F32).reshape(())


def _scalar(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=_F32)


def _ip(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Flat inner product as elementwise multiply + full sum."""
    return torch.sum(a * b)


def _two_loop(g, s_hist, y_hist, rho, head: int, gamma):
    """H·g by the two-loop recursion over the circular history. Unused slots
    carry rho=0, so they contribute nothing; all m slots are visited, newest
    first, as in the JAX version."""
    m = rho.shape[0]
    q = g
    alpha = []
    for i in range(m):
        idx = (head - 1 - i) % m
        a = rho[idx] * _ip(s_hist[idx], q)
        q = q - a * y_hist[idx]
        alpha.append((idx, a))
    r = gamma * q
    for i in range(m - 1, -1, -1):
        idx, a = alpha[i]
        beta = rho[idx] * _ip(y_hist[idx], r)
        r = r + s_hist[idx] * (a - beta)
    return r


def _cubic_min(a, fa, dfa, b, fb, dfb):
    """Minimizer of the cubic interpolant through (a,fa,dfa), (b,fb,dfb)."""
    d1 = dfa + dfb - 3.0 * (fa - fb) / (a - b)
    arg = d1 * d1 - dfa * dfb
    d2 = torch.sqrt(torch.clamp(arg, min=0.0)) * torch.sign(b - a)
    denom = dfb - dfa + 2.0 * d2
    x = b - (b - a) * (dfb + d2 - d1) / denom
    bad = bool(arg < 0.0) or bool(torch.abs(denom) < 1e-20) or not bool(torch.isfinite(x))
    return 0.5 * (a + b) if bad else x


def _wolfe_line_search(value_and_grad_1d, f0, g0, dphi0, a_init, opts: LBFGSOptions):
    """Strong-Wolfe line search (Nocedal & Wright alg. 3.5/3.6): stage 0
    brackets, stage 1 zooms. ``value_and_grad_1d(a)`` returns (f, dphi, g)
    at step a. Returns (a, f, g, n_evals, ok)."""
    c1, c2 = opts.resolved_c1c2()
    zero = _scalar(0.0)
    stage, i, n_evals = 0, 0, 0
    done = ok = False
    a = a_init
    a_prev, f_prev, dphi_prev, g_prev = zero, f0, dphi0, g0
    a_lo, f_lo, dphi_lo, g_lo = zero, f0, dphi0, g0
    a_hi, f_hi, dphi_hi = zero, f0, dphi0
    a_star, f_star, g_star = zero, f0, g0

    while not done and n_evals < opts.maxls:
        f_a, dphi_a, g_a = value_and_grad_1d(a)
        n_evals += 1
        armijo_violated = bool(f_a > f0 + c1 * a * dphi0)
        strong_wolfe = bool(torch.abs(dphi_a) <= -c2 * dphi0)
        if stage == 0:
            armijo_fail = armijo_violated or (bool(f_a >= f_prev) and i > 0)
            accept = (not armijo_fail) and strong_wolfe
            go_zoom = (armijo_fail or bool(dphi_a >= 0.0)) and not accept
            i += 1
            done = ok = accept
            if accept:
                a_star, f_star, g_star = a, f_a, g_a
            elif go_zoom:
                stage = 1
                if armijo_fail:  # bracket (prev, a), lo = prev
                    a_lo, f_lo, dphi_lo, g_lo = a_prev, f_prev, dphi_prev, g_prev
                    a_hi, f_hi, dphi_hi = a, f_a, dphi_a
                else:  # bracket (a, prev), lo = a
                    a_lo, f_lo, dphi_lo, g_lo = a, f_a, dphi_a, g_a
                    a_hi, f_hi, dphi_hi = a_prev, f_prev, dphi_prev
            else:  # expand
                a_prev, f_prev, dphi_prev, g_prev = a, f_a, dphi_a, g_a
                a = 2.0 * a
        else:
            zoom_armijo_fail = armijo_violated or bool(f_a >= f_lo)
            accept = (not zoom_armijo_fail) and strong_wolfe
            i += 1
            done = ok = accept
            if accept:
                a_star, f_star, g_star = a, f_a, g_a
            if zoom_armijo_fail:
                a_hi, f_hi, dphi_hi = a, f_a, dphi_a
            else:
                if bool(dphi_a * (a_hi - a_lo) >= 0.0):
                    a_hi, f_hi, dphi_hi = a_lo, f_lo, dphi_lo
                a_lo, f_lo, dphi_lo, g_lo = a, f_a, dphi_a, g_a

        if stage == 1:  # next trial: safeguarded cubic inside the bracket
            a_cubic = _cubic_min(a_lo, f_lo, dphi_lo, a_hi, f_hi, dphi_hi)
            lo_, hi_ = torch.minimum(a_lo, a_hi), torch.maximum(a_lo, a_hi)
            width = hi_ - lo_
            a = torch.minimum(torch.maximum(a_cubic, lo_ + 0.1 * width), hi_ - 0.1 * width)
            if bool(width <= 1e-10 * torch.clamp(hi_, min=1.0)):
                done = True  # degenerate bracket: give up

    if ok:
        return a_star, f_star, g_star, n_evals, True
    # On failure take the best bracketing point (a_lo) if it improves f0.
    if bool(f_lo < f0) and bool(a_lo > 0.0):
        return a_lo, f_lo, g_lo, n_evals, True
    return zero, f0, g0, n_evals, False


def lbfgs_minimize(value_and_grad: Callable, x0: torch.Tensor,
                   opts: LBFGSOptions = LBFGSOptions(), history: dict | None = None,
                   return_history: bool = False, has_aux: bool = False):
    """Minimize f with L-BFGS.

    Args:
      value_and_grad: x -> (f, g), or ((f, aux), g) with ``has_aux``; f a
        0-d tensor, g shaped like x0.
      x0: initial point (any shape; the history slots are [memory, *shape]).
      history: curvature memory from a previous call (``return_history``) to
        warm-start the Hessian approximation. It is copied, not modified.
      return_history: also return the final curvature memory.

    Returns ``LBFGSResult`` (aux is the objective's aux at x0) or
    ``(LBFGSResult, history)``.
    """
    if opts.line_search != "zoom":
        raise NotImplementedError(
            f"line_search={opts.line_search!r}: only 'zoom' is ported; the "
            "Moré-Thuente search waits (ROADMAP.md)")
    m = opts.memory
    dtype, dev = x0.dtype, x0.device

    def vg(x):
        if has_aux:
            (f, _), g = value_and_grad(x)
        else:
            f, g = value_and_grad(x)
        return _host(f), g.to(dtype)

    if has_aux:
        (f0, aux0), g0 = value_and_grad(x0)
        f0, g0 = _host(f0), g0.to(dtype)
    else:
        f0, g0 = vg(x0)
        aux0 = None

    if history is None:
        s_hist = torch.zeros((m,) + tuple(x0.shape), dtype=dtype, device=dev)
        y_hist = torch.zeros_like(s_hist)
        rho = torch.zeros((m,), dtype=_F32)
        head, count, gamma = 0, 0, _scalar(1.0)
    else:
        s_hist, y_hist = history["s_hist"].clone(), history["y_hist"].clone()
        rho = history["rho"].clone()
        head, count, gamma = int(history["head"]), int(history["count"]), history["gamma"]

    x, f, g = x0, f0, g0
    k, n_evals, status, ftol_strikes = 0, 1, 2, 0
    done = False
    while not done and k < opts.maxiter:
        d = -_two_loop(g, s_hist, y_hist, rho, head, gamma)
        dphi0 = _host(_ip(g, d))
        if bool(dphi0 >= 0.0):  # not a descent direction: steepest descent
            d = -g
            dphi0 = -_host(_ip(g, g))
        if k == 0 and count == 0:
            a_init = torch.minimum(_scalar(1.0), 1.0 / _host(torch.sum(torch.abs(g))))
        else:
            a_init = _scalar(1.0)

        def vg_1d(a, x=x, d=d):
            fa, ga = vg(x + a * d)
            return fa, _host(_ip(ga, d)), ga

        a, f_new, g_new, ls_evals, ok = _wolfe_line_search(vg_1d, f, g, dphi0, a_init, opts)
        x_new = x + a * d

        s = x_new - x
        y = g_new - g
        sy = _host(_ip(s, y))
        yy = _host(_ip(y, y))
        if ok and bool(sy > 1e-10 * yy):
            idx = head % m
            s_hist[idx] = s
            y_hist[idx] = y
            rho[idx] = 1.0 / sy
            head += 1
            count = min(count + 1, m)
            gamma = sy / yy

        restart = (not ok) and count > 0 and opts.restart_on_ls_fail
        if restart:
            rho = torch.zeros_like(rho)
            count, gamma = 0, _scalar(1.0)

        gtol_hit = bool(torch.max(torch.abs(g_new)) <= opts.gtol)
        ftol_tick = bool((f - f_new) <= opts.ftol * torch.clamp(
            torch.maximum(torch.abs(f), torch.abs(f_new)), min=1.0))
        ftol_strikes = ftol_strikes + 1 if (ftol_tick and ok) else 0
        ftol_hit = ftol_strikes >= opts.ftol_patience
        ls_failed = (not ok) and not restart
        if gtol_hit:
            status = 0
        elif ftol_hit:
            status = 1
        elif ls_failed:
            status = 3
        if ok:
            x, f, g = x_new, f_new, g_new
        k += 1
        n_evals += ls_evals
        done = gtol_hit or ftol_hit or ls_failed

    res = LBFGSResult(x=x, f=f, g=g, n_iters=k, n_evals=n_evals, status=status, aux=aux0)
    if return_history:
        return res, dict(s_hist=s_hist, y_hist=y_hist, rho=rho, head=head,
                         count=count, gamma=gamma)
    return res
