"""L-BFGS with a Moré-Thuente or a strong-Wolfe zoom line search, eager
(counterpart of audio_style_transfer_tpu/transfer/lbfgs.py).

The JAX version is one XLA program of nested while loops. Here the same
state machine runs as Python loops: the iterate, the gradient and the
curvature memory stay on the iterate's device, while the scalars that steer
the control flow (f, the directional derivatives, the step) are float32
0-d tensors on the host, so the branch decisions round as the JAX float32
ones do. Each evaluation therefore synchronises with the device once or
twice; removing those syncs is later work.

Every read of a device value on the host goes through ``_host``. Under a
``torch.profiler`` capture the call is one ``lbfgs.minimize`` span, each
call of the objective one ``lbfgs.eval`` span and each host read one
``lbfgs.host_read`` span (``utils/profiling.py::span``), so the count of
host reads is the count of the optimizer's syncs with the device.

``line_search="mt"`` (the default, as in JAX) is MINPACK's dcsrch/dcstep, the
search inside SciPy's L-BFGS-B; ``"zoom"`` is the plainer bracketing search
the transfer engine runs. The JAX versions compute every branch and select;
here only the branch taken is computed, with the same float32 arithmetic.

A sharded iterate (``group``: each rank holds a slice of x, of the gradient
and of the curvature memory, as JAX's GSPMD shards them) reduces every inner
product and norm over the ranks, so every scalar that steers the control
flow is the same on every rank and all ranks take the same branches.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from audio_style_transfer_tpu_torch.utils.profiling import span

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
    # "mt": MINPACK's dcsrch/dcstep with L-BFGS-B's constants (ftol=1e-3,
    # gtol=0.9, xtol=0.1); "zoom": a strong-Wolfe bracketing zoom with a
    # tighter curvature constant (c2=0.5).
    line_search: str = "mt"
    # None = the search's default: mt -> (1e-3, 0.9), zoom -> (1e-4, 0.5).
    c1: float | None = None
    c2: float | None = None
    # dcsrch interval tolerance (mt only).
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


def _host(v: torch.Tensor, dtype: torch.dtype = _F32) -> torch.Tensor:
    """A 0-d host copy of a scalar tensor in ``dtype`` (one device sync)."""
    with span("lbfgs.host_read"):
        return v.detach().to("cpu", dtype).reshape(())


def _scalar(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=_F32)


def _over_ranks(v: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A rank's partial sum (or max) reduced over ``group``; None: unchanged."""
    if group is not None:
        dist.all_reduce(v, op=op, group=group)
    return v


def _ip(a: torch.Tensor, b: torch.Tensor, group=None) -> torch.Tensor:
    """Flat inner product as elementwise multiply + full sum (over the ranks
    of ``group`` too)."""
    return _over_ranks(torch.sum(a * b), group)


def _two_loop(g, s_hist, y_hist, rho, head: int, gamma, group=None):
    """H·g by the two-loop recursion over the circular history. Unused slots
    carry rho=0, so they contribute nothing; all m slots are visited, newest
    first, as in the JAX version."""
    m = rho.shape[0]
    q = g
    alpha = []
    for i in range(m):
        idx = (head - 1 - i) % m
        a = rho[idx] * _ip(s_hist[idx], q, group)
        q = q - a * y_hist[idx]
        alpha.append((idx, a))
    r = gamma * q
    for i in range(m - 1, -1, -1):
        idx, a = alpha[i]
        beta = rho[idx] * _ip(y_hist[idx], r, group)
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


def _safe(q):
    """q, pushed away from zero to +-1e-30 (the guard of JAX's branch-free
    dcstep; it only acts where MINPACK would divide by zero)."""
    if bool(torch.abs(q) < 1e-30):
        return q.new_tensor(-1e-30 if bool(q < 0) else 1e-30)
    return q


def _dcstep(stx, fx, dx, sty, fy, dy, stp, fp, dp, brackt: bool, stpmin, stpmax):
    """MINPACK dcstep: one safeguarded trial-step update (dcstep.f).

    (stx, fx, dx) is the best step so far, (sty, fy, dy) the other endpoint,
    (stp, fp, dp) the step just evaluated. Returns the updated
    (stx, fx, dx, sty, fy, dy, stp, brackt)."""
    sgnd = dp * torch.sign(dx)

    def cubic(theta, da, db, flip):
        # gamma of the cubic through the two points, scaled against overflow.
        sc = _safe(torch.maximum(torch.maximum(torch.abs(theta), torch.abs(da)),
                                 torch.abs(db)))
        g = sc * torch.sqrt(torch.clamp((theta / sc) ** 2 - (da / sc) * (db / sc), min=0.0))
        return -g if flip else g

    if bool(fp > fx):
        # case 1: a higher value; the minimum is bracketed.
        theta = 3.0 * (fx - fp) / _safe(stp - stx) + dx + dp
        g = cubic(theta, dx, dp, bool(stp < stx))
        r = ((g - dx) + theta) / _safe(((g - dx) + g) + dp)
        stpc = stx + r * (stp - stx)
        stpq = stx + ((dx / _safe((fx - fp) / _safe(stp - stx) + dx)) / 2.0) * (stp - stx)
        if bool(torch.abs(stpc - stx) < torch.abs(stpq - stx)):
            stpf = stpc
        else:
            stpf = stpc + (stpq - stpc) / 2.0
        return stx, fx, dx, stp, fp, dp, stpf, True
    if bool(sgnd < 0.0):
        # case 2: lower value, derivatives of opposite sign; bracketed.
        theta = 3.0 * (fx - fp) / _safe(stp - stx) + dx + dp
        g = cubic(theta, dx, dp, bool(stp > stx))
        r = ((g - dp) + theta) / _safe(((g - dp) + g) + dx)
        stpc = stp + r * (stx - stp)
        stpq = stp + (dp / _safe(dp - dx)) * (stx - stp)
        stpf = stpc if bool(torch.abs(stpc - stp) > torch.abs(stpq - stp)) else stpq
        return stp, fp, dp, stx, fx, dx, stpf, True
    if bool(torch.abs(dp) < torch.abs(dx)):
        # case 3: lower value, same sign, |derivative| decreasing.
        theta = 3.0 * (fx - fp) / _safe(stp - stx) + dx + dp
        g = cubic(theta, dx, dp, bool(stp > stx))
        r = ((g - dp) + theta) / _safe((g + (dx - dp)) + g)
        if bool(r < 0.0) and bool(g != 0.0):
            stpc = stp + r * (stx - stp)
        else:
            stpc = stpmax if bool(stp > stx) else stpmin
        stpq = stp + (dp / _safe(dp - dx)) * (stx - stp)
        if brackt:
            stpf = stpc if bool(torch.abs(stpc - stp) < torch.abs(stpq - stp)) else stpq
            bound = stp + 0.66 * (sty - stp)
            stpf = torch.minimum(bound, stpf) if bool(stp > stx) else torch.maximum(bound, stpf)
        else:
            stpf = stpc if bool(torch.abs(stpc - stp) > torch.abs(stpq - stp)) else stpq
            stpf = torch.minimum(torch.maximum(stpf, stpmin), stpmax)
        return stp, fp, dp, sty, fy, dy, stpf, brackt
    # case 4: lower value, same sign, |derivative| not decreasing.
    if brackt:
        theta = 3.0 * (fp - fy) / _safe(sty - stp) + dy + dp
        g = cubic(theta, dy, dp, bool(stp > sty))
        r = ((g - dp) + theta) / _safe(((g - dp) + g) + dy)
        stpf = stp + r * (sty - stp)
    else:
        stpf = stpmax if bool(stp > stx) else stpmin
    return stp, fp, dp, sty, fy, dy, stpf, brackt


def _mt_line_search(value_and_grad_1d, f0, g0, dphi0, a_init, opts: LBFGSOptions):
    """Moré-Thuente line search: MINPACK's dcsrch routine (the search inside
    SciPy's L-BFGS-B, lbfgsb.f lnsrlb), one objective evaluation per
    iteration. ``value_and_grad_1d(a)`` returns (f, dphi, g) at step a.

    Stage 1 works on the modified function psi(a) = f(a) - f0 - c1 a dphi0
    until a step with psi <= 0 and dphi >= 0 is found. On Wolfe convergence
    the converged trial is accepted; on maxls exhaustion or a dcsrch warning
    exit the best evaluated point is taken if it improves f0.
    The scalars take f0's dtype (float32 inside ``lbfgs_minimize``).
    Returns (a, f, g, n_evals, ok)."""
    c1, c2, xtol, stpmin, stpmax, xtrapl, xtrapu, zero = (
        f0.new_tensor(v) for v in (*opts.resolved_c1c2(), opts.xtol, 1e-20, 1e20, 1.1, 4.0, 0.0))
    finit, ginit = f0, dphi0
    gtest = c1 * ginit

    stp = torch.minimum(torch.maximum(torch.as_tensor(a_init, dtype=f0.dtype), stpmin), stpmax)
    brackt, stage1 = False, True
    stx, fx, dx = zero, finit, ginit
    sty, fy, dy = zero, finit, ginit
    stmin, stmax = zero, stp + xtrapu * stp
    width, width1 = stpmax - stpmin, (stpmax - stpmin) / 0.5
    n_evals, done, wolfe = 0, False, False
    a_eval, f, g = zero, f0, g0
    a_best, f_best, g_best = zero, f0, g0

    while not done and n_evals < opts.maxls:
        f, dphi, g = value_and_grad_1d(stp)
        n_evals += 1
        a_eval = stp
        ftest = finit + stp * gtest

        # dcsrch.f: stage 1 ends once f <= ftest and dphi >= min(c1, c2) dphi0.
        if stage1 and bool(f <= ftest) and bool(dphi >= torch.minimum(c1, c2) * ginit):
            stage1 = False
        converged = bool(f <= ftest) and bool(torch.abs(dphi) <= c2 * (-ginit))
        warn = (
            (brackt and (bool(stp <= stmin) or bool(stp >= stmax)))
            or (brackt and bool(stmax - stmin <= xtol * stmax))
            or (bool(stp == stpmax) and bool(f <= ftest) and bool(dphi <= gtest))
            or (bool(stp == stpmin) and (bool(f > ftest) or bool(dphi >= gtest)))
        )

        # Stage-1 steps that beat fx but fail sufficient decrease update the
        # interval on the modified function.
        use_mod = stage1 and bool(f <= fx) and bool(f > ftest)
        if use_mod:
            stx, fx, dx, sty, fy, dy, stp_new, brackt_new = _dcstep(
                stx, fx - stx * gtest, dx - gtest, sty, fy - sty * gtest, dy - gtest,
                stp, f - stp * gtest, dphi - gtest, brackt, stmin, stmax)
            fx, fy = fx + stx * gtest, fy + sty * gtest
            dx, dy = dx + gtest, dy + gtest
        else:
            stx, fx, dx, sty, fy, dy, stp_new, brackt_new = _dcstep(
                stx, fx, dx, sty, fy, dy, stp, f, dphi, brackt, stmin, stmax)
        brackt = brackt_new

        if brackt:
            # Force bisection when the bracket shrinks too slowly.
            wid = torch.abs(sty - stx)
            if bool(wid >= 0.66 * width1):
                stp_new = stx + 0.5 * (sty - stx)
            width1, width = width, wid
            stmin, stmax = torch.minimum(stx, sty), torch.maximum(stx, sty)
        else:
            stmin = stp_new + xtrapl * (stp_new - stx)
            stmax = stp_new + xtrapu * (stp_new - stx)
        stp_new = torch.minimum(torch.maximum(stp_new, stpmin), stpmax)
        # No further progress possible: park at the best point.
        if brackt and (bool(stp_new <= stmin) or bool(stp_new >= stmax)
                       or bool(stmax - stmin <= xtol * stmax)):
            stp_new = stx

        done = converged or warn
        wolfe = wolfe or converged
        if bool(f < f_best):
            a_best, f_best, g_best = stp, f, g
        if not done:
            stp = stp_new

    if wolfe:
        return a_eval, f, g, n_evals, True
    if bool(f_best < f0):
        return a_best, f_best, g_best, n_evals, True
    return zero, f0, g0, n_evals, False


def lbfgs_minimize(value_and_grad: Callable, x0: torch.Tensor,
                   opts: LBFGSOptions = LBFGSOptions(), history: dict | None = None,
                   return_history: bool = False, has_aux: bool = False, group=None):
    """Minimize f with L-BFGS.

    Args:
      value_and_grad: x -> (f, g), or ((f, aux), g) with ``has_aux``; f a
        0-d tensor, g shaped like x0.
      x0: initial point (any shape; the history slots are [memory, *shape]).
      history: curvature memory from a previous call (``return_history``) to
        warm-start the Hessian approximation. It is copied, not modified.
      return_history: also return the final curvature memory.
      group: a process group over which x0 is sharded (each rank passes its
        slice, and ``value_and_grad`` returns the same f on every rank and
        the rank's slice of g); None: x0 is the whole iterate.

    Returns ``LBFGSResult`` (aux is the objective's aux at x0) or
    ``(LBFGSResult, history)``.
    """
    if opts.line_search not in ("mt", "zoom"):
        raise ValueError(f"line_search must be 'mt' or 'zoom', got {opts.line_search!r}")
    with span("lbfgs.minimize"):
        return _minimize(value_and_grad, x0, opts, history, return_history, has_aux, group)


def _minimize(value_and_grad, x0, opts, history, return_history, has_aux, group):
    """``lbfgs_minimize``'s body, inside its ``lbfgs.minimize`` span."""
    search = _mt_line_search if opts.line_search == "mt" else _wolfe_line_search
    m = opts.memory
    dtype, dev = x0.dtype, x0.device

    def vg(x):
        """(f on the host, g, aux or None) at x."""
        with span("lbfgs.eval"):
            out = value_and_grad(x)
        (f, aux), g = out if has_aux else ((out[0], None), out[1])
        return _host(f), g.to(dtype), aux

    f0, g0, aux0 = vg(x0)

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
        d = -_two_loop(g, s_hist, y_hist, rho, head, gamma, group)
        dphi0 = _host(_ip(g, d, group))
        if bool(dphi0 >= 0.0):  # not a descent direction: steepest descent
            d = -g
            dphi0 = -_host(_ip(g, g, group))
        # The small first step applies only with an empty memory: 1/||d||_2
        # for the Moré-Thuente search (lnsrlb.f), 1/||g||_1 for zoom.
        if k != 0 or count != 0:
            a_init = _scalar(1.0)
        elif opts.line_search == "mt":
            a_init = 1.0 / torch.sqrt(_host(_ip(d, d, group)))
        else:
            a_init = torch.minimum(
                _scalar(1.0), 1.0 / _host(_over_ranks(torch.sum(torch.abs(g)), group)))

        def vg_1d(a, x=x, d=d):
            fa, ga, _ = vg(x + a * d)
            return fa, _host(_ip(ga, d, group)), ga

        a, f_new, g_new, ls_evals, ok = search(vg_1d, f, g, dphi0, a_init, opts)
        x_new = x + a * d

        s = x_new - x
        y = g_new - g
        sy = _host(_ip(s, y, group))
        yy = _host(_ip(y, y, group))
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

        g_max = _over_ranks(torch.max(torch.abs(g_new)), group, dist.ReduceOp.MAX)
        gtol_hit = bool(_host(g_max <= opts.gtol, torch.bool))
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
