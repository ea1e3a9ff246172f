"""The port's Moré-Thuente line search (transfer/lbfgs.py::_mt_line_search)
trial for trial against SciPy's DCSRCH and the JAX port of the same routine,
on the scalar objectives of tests/test_mt_line_search.py (float64, L-BFGS-B's
constants ftol=1e-3, gtol=0.9, xtol=0.1), and ``lbfgs_minimize`` with
``line_search="mt"`` against the JAX L-BFGS in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize._dcsrch import DCSRCH
from torch_helpers import TOY, jax_params_np, n, t, torch_params

from audio_style_transfer_tpu.models.wavenet_ae import WaveNetAEConfig as JCfg
from audio_style_transfer_tpu.signal.mu_law import mu_law_numpy
from audio_style_transfer_tpu.transfer import lbfgs as jlbfgs
from audio_style_transfer_tpu.transfer import losses as jlosses
from audio_style_transfer_tpu_torch.models.wavenet_ae import WaveNetAEConfig as TCfg
from audio_style_transfer_tpu_torch.transfer import lbfgs as tlbfgs
from audio_style_transfer_tpu_torch.transfer import losses as tlosses

OPTS = tlbfgs.LBFGSOptions(maxls=30)
C1, C2 = OPTS.resolved_c1c2()
F64 = torch.float64


def _mt1(a, b=2.0):
    return -a / (a**2 + b)


def _dmt1(a, b=2.0):
    return (a**2 - b) / (a**2 + b) ** 2


CASES = [
    (lambda a: (a - 2.0) ** 2, lambda a: 2.0 * (a - 2.0), 1.0, "quadratic"),
    (lambda a: (a - 2.0) ** 2, lambda a: 2.0 * (a - 2.0), 37.0, "quad-overshoot"),
    (lambda a: -a * np.exp(-a), lambda a: (a - 1.0) * np.exp(-a), 0.1, "exp-valley"),
    (lambda a: np.cos(0.5 + a), lambda a: -np.sin(0.5 + a), 0.5, "cosine"),
    (lambda a: (a**2 - 1.5 * a) / (a**2 + 1.0),
     lambda a: ((2 * a - 1.5) * (a**2 + 1) - (a**2 - 1.5 * a) * 2 * a) / (a**2 + 1) ** 2,
     0.05, "rational-plateau"),
    (_mt1, _dmt1, 0.001, "mt1-tiny-start"),
    (_mt1, _dmt1, 1000.0, "mt1-huge-start"),
    # Extrapolate-then-bracket transition: the first interpolation inside a
    # fresh bracket must not be clamped to the stale trust interval.
    (lambda a: -a + 0.5 * max(0.0, a - 1.0) ** 4,
     lambda a: -1.0 + 2.0 * max(0.0, a - 1.0) ** 3, 0.01, "kink"),
]
IDS = [c[3] for c in CASES]


def _run_port(phi, dphi, a0, opts=OPTS):
    trials = []

    def vg1d(a):
        a = float(a)
        trials.append(a)
        d = dphi(a)
        return (torch.tensor(phi(a), dtype=F64), torch.tensor(d, dtype=F64),
                torch.tensor([d], dtype=F64))

    d0 = dphi(0.0)
    a, f, g, n_evals, ok = tlbfgs._mt_line_search(
        vg1d, torch.tensor(phi(0.0), dtype=F64), torch.tensor([d0], dtype=F64),
        torch.tensor(d0, dtype=F64), a0, opts)
    return float(a), float(f), n_evals, ok, trials


def _run_jax(phi, dphi, a0):
    trials = []

    def vg1d(a):
        a = float(a)
        trials.append(a)
        d = dphi(a)
        return (jnp.asarray(phi(a), jnp.float64), jnp.asarray(d, jnp.float64),
                jnp.asarray([d], jnp.float64))

    with jax.enable_x64(True), jax.disable_jit():
        d0 = dphi(0.0)
        a, f, g, n_evals, ok = jlbfgs._mt_line_search(
            vg1d, jnp.asarray(phi(0.0), jnp.float64), jnp.asarray([d0], jnp.float64),
            jnp.asarray(d0, jnp.float64), a0, jlbfgs.LBFGSOptions(maxls=30))
        return float(a), float(f), int(n_evals), bool(ok), trials


def _run_scipy(phi, dphi, a0):
    trials = []

    def phi_rec(a):
        trials.append(float(a))
        return phi(a)

    d = DCSRCH(phi_rec, dphi, C1, C2, OPTS.xtol, 1e-20, 1e20)
    stp, f, _, task = d(a0, phi0=phi(0.0), derphi0=dphi(0.0), maxiter=30)
    ok = stp is not None and b"CONV" in task
    return (0.0 if stp is None else float(stp)), f, trials, ok


@pytest.mark.parametrize("phi,dphi,a0,name", CASES, ids=IDS)
def test_trial_sequence_matches_scipy_dcsrch(phi, dphi, a0, name):
    """Identical evaluation count and trial steps (tiny float64 slack: theta
    and gamma are evaluated in another association order than dcstep.f)."""
    a, f, n_evals, ok, trials = _run_port(phi, dphi, a0)
    a_sp, f_sp, trials_sp, ok_sp = _run_scipy(phi, dphi, a0)
    assert ok == ok_sp, (name, trials, trials_sp)
    assert n_evals == len(trials) == len(trials_sp), (trials, trials_sp)
    np.testing.assert_allclose(trials, trials_sp, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(a, a_sp, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("phi,dphi,a0,name", CASES, ids=IDS)
def test_trial_sequence_matches_jax(phi, dphi, a0, name):
    """The port computes only the branch taken, JAX computes all four and
    selects: the same float64 operations, so the trials agree to the last
    bits."""
    a, f, n_evals, ok, trials = _run_port(phi, dphi, a0)
    a_j, f_j, n_j, ok_j, trials_j = _run_jax(phi, dphi, a0)
    assert (ok, n_evals) == (ok_j, n_j)
    np.testing.assert_allclose(trials, trials_j, rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose([a, f], [a_j, f_j], rtol=1e-13, atol=1e-15)


@pytest.mark.parametrize("phi,dphi,a0,name", CASES, ids=IDS)
def test_wolfe_conditions_hold_on_accept(phi, dphi, a0, name):
    a, f, _, ok, _ = _run_port(phi, dphi, a0)
    assert ok
    f0, d0 = phi(0.0), dphi(0.0)
    assert f <= f0 + C1 * a * d0 + 1e-12
    assert abs(dphi(a)) <= C2 * abs(d0) + 1e-12


def test_maxls_exhaustion_returns_an_evaluated_point():
    """(a, f, g) come from the same evaluation, not from the next trial that
    was never evaluated."""
    phi, dphi = CASES[-1][0], CASES[-1][1]
    a, f, n_evals, ok, trials = _run_port(phi, dphi, 0.01, tlbfgs.LBFGSOptions(maxls=3))
    assert n_evals == 3
    if ok:
        assert any(abs(a - e) < 1e-12 for e in [0.0] + trials), (a, trials)
        assert abs(f - phi(a)) < 1e-9


def test_defaults_follow_the_line_search():
    assert tlbfgs.LBFGSOptions().line_search == jlbfgs.LBFGSOptions().line_search == "mt"
    for ls in ("mt", "zoom"):
        assert (tlbfgs.LBFGSOptions(line_search=ls).resolved_c1c2()
                == jlbfgs.LBFGSOptions(line_search=ls).resolved_c1c2())
    assert tlbfgs.LBFGSOptions(c1=0.1, c2=0.2).resolved_c1c2() == (0.1, 0.2)
    with pytest.raises(ValueError, match="line_search"):
        tlbfgs.lbfgs_minimize(lambda x: (x.sum(), torch.ones_like(x)), torch.zeros(3),
                              tlbfgs.LBFGSOptions(line_search="armijo"))


def test_lbfgs_mt_on_quadratic_matches_jax():
    rng = np.random.RandomState(0)
    m = rng.randn(24, 24).astype(np.float32)
    a = (m @ m.T / 24 + np.eye(24, dtype=np.float32)).astype(np.float32)
    b = rng.randn(24).astype(np.float32)
    x0 = np.zeros(24, np.float32)
    # maxiter 6 stops before the float32 plateau (see the zoom test).
    aj, bj = jnp.asarray(a), jnp.asarray(b)
    jres = jlbfgs.lbfgs_minimize(
        jax.value_and_grad(lambda x: 0.5 * x @ aj @ x - bj @ x), jnp.asarray(x0),
        jlbfgs.LBFGSOptions(maxiter=6))
    at, bt = t(a), t(b)
    tres = tlbfgs.lbfgs_minimize(lambda x: (0.5 * x @ at @ x - bt @ x, at @ x - bt), t(x0),
                                 tlbfgs.LBFGSOptions(maxiter=6))
    assert tres.n_evals == int(jres.n_evals)
    assert tres.status == int(jres.status)
    np.testing.assert_allclose(float(tres.f), float(jres.f), rtol=1e-5)
    np.testing.assert_allclose(n(tres.x), n(jres.x), rtol=1e-4, atol=1e-5)


def test_lbfgs_mt_on_rosenbrock_converges_through_restarts():
    """Float32 Rosenbrock: failed searches with history trigger the memory
    restart, not termination, as in the JAX package's test."""
    def vg(x):
        xv = x.detach().requires_grad_(True)
        f = torch.sum(100.0 * (xv[1:] - xv[:-1] ** 2) ** 2 + (1.0 - xv[:-1]) ** 2)
        (g,) = torch.autograd.grad(f, xv)
        return f.detach(), g

    x0 = torch.tensor([-1.2, 1.0, -1.2, 1.0, 0.5, 0.5])
    res = tlbfgs.lbfgs_minimize(vg, x0, tlbfgs.LBFGSOptions(maxiter=400))
    assert float(res.f) < 1e-6, (float(res.f), res.status)


def test_lbfgs_mt_on_toy_transfer_loss_matches_jax():
    """The toy transfer loss from the content clip, 5 iterations: equal
    evaluation counts, f within 1e-5 (float32 sums in different orders)."""
    pnp = jax_params_np(**TOY)
    jp, tp = jax.tree.map(jnp.asarray, pnp), torch_params(pnp)
    kw = dict(cont_lyr_ids=(3,), style_layer_ids=(0, 1, 2))
    spec_j, spec_t = jlosses.LossSpec(**kw), tlosses.LossSpec(**kw)
    rng = np.random.RandomState(0)
    audio = (0.3 * np.sin(np.arange(4096) * 0.05) + 0.05 * rng.randn(4096)).astype(np.float32)
    x0 = mu_law_numpy(audio).astype(np.float32)
    other = mu_law_numpy(0.2 * rng.randn(1, 4096)).astype(np.float32)
    phi_c, phi_s = jlosses.transfer_embeds(jp, jnp.asarray(other), JCfg(**TOY), spec_j)

    def jloss(x):
        return jlosses.transfer_loss(jp, x[None], phi_c, phi_s, JCfg(**TOY), spec_j)

    pc, ps = t(phi_c), t(phi_s)

    def tvg(x):
        xv = x.detach().requires_grad_(True)
        loss, parts = tlosses.transfer_loss(tp, xv[None], pc, ps, TCfg(**TOY), spec_t)
        (g,) = torch.autograd.grad(loss, xv)
        return (loss.detach(), parts), g

    jres = jlbfgs.lbfgs_minimize(jax.jit(jax.value_and_grad(jloss, has_aux=True)),
                                 jnp.asarray(x0), jlbfgs.LBFGSOptions(maxiter=5), has_aux=True)
    tres = tlbfgs.lbfgs_minimize(tvg, t(x0), tlbfgs.LBFGSOptions(maxiter=5), has_aux=True)
    assert tres.n_evals == int(jres.n_evals)
    np.testing.assert_allclose(float(tres.f), float(jres.f), rtol=1e-5)
    np.testing.assert_allclose(n(tres.aux["loss"]), n(jres.aux["loss"]), rtol=1e-5)
