"""The port's NMF (analysis/nmf.py) and ADMM optimal transport
(analysis/ot.py) vs the JAX package, float32 on the CPU, from the same
inputs and the same initial factors.

Tolerance 1e-4 of the largest entry. Measured drift between the two
frameworks (different float32 summation orders in the matrix products): NMF
factors after 200 alternating multiplicative steps 2.5e-6, the 400-step
transform 3e-7, the ADMM plan after 1000-4500 iterations 1e-5, with
iteration counts equal or one apart (a residual that crosses its threshold
within rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import n, t

from audio_style_transfer_tpu.analysis import nmf as jnmf
from audio_style_transfer_tpu.analysis import ot as jot
from audio_style_transfer_tpu_torch.analysis import nmf as tnmf
from audio_style_transfer_tpu_torch.analysis import ot as tot

TOL = 1e-4


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(n(got), want, rtol=0, atol=tol * float(np.abs(want).max()))


def _data(seed=0, lead=(3,), rows=64, feats=16, k=4):
    rng = np.random.RandomState(seed)
    x = np.abs(rng.randn(*lead, rows, feats)).astype(np.float32)
    w0 = np.abs(rng.randn(*lead, rows, k)).astype(np.float32)
    h0 = np.abs(rng.randn(*lead, k, feats)).astype(np.float32)
    return x, w0, h0


def _jax_nmf_from(x, w, h, max_iter=200):
    """The JAX ``nmf`` loop from explicit initial factors."""
    def body(_, carry):
        w, h = carry
        w = jnmf._mu_update_w(x, w, h)
        return w, jnmf._mu_update_h(x, w, h)
    return jax.lax.fori_loop(0, max_iter, body, (w, h))


def test_multiplicative_updates_match_jax():
    x, w0, h0 = _data(lead=())
    _close(tnmf._mu_update_w(t(x), t(w0), t(h0)), jnmf._mu_update_w(x, w0, h0), 1e-6)
    _close(tnmf._mu_update_h(t(x), t(w0), t(h0)), jnmf._mu_update_h(x, w0, h0), 1e-6)


def test_nmf_from_the_same_factors_matches_jax():
    x, w0, h0 = _data()
    tw, th = tnmf.nmf(t(x), 4, init=(w0, h0))
    jw, jh = jax.vmap(_jax_nmf_from)(jnp.asarray(x), jnp.asarray(w0), jnp.asarray(h0))
    _close(tw, jw)
    _close(th, jh)
    # A stack of problems equals the problems one by one (the batched and
    # the plain matrix product sum in different orders).
    w1, h1 = tnmf.nmf(t(x[1]), 4, init=(w0[1], h0[1]))
    _close(w1, n(tw[1]))
    _close(h1, n(th[1]))


def test_nmf_initial_factors_come_from_the_generator():
    x, _, _ = _data(lead=())
    a = tnmf.nmf(t(x), 4, max_iter=3, generator=torch.Generator().manual_seed(5))
    b = tnmf.nmf(t(x), 4, max_iter=3, generator=torch.Generator().manual_seed(5))
    c = tnmf.nmf(t(x), 4, max_iter=3, generator=torch.Generator().manual_seed(6))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[1], c[1])
    w, h = tnmf.nmf(t(x), 4)
    assert w.shape == (64, 4) and h.shape == (4, 16)
    assert bool((w >= 0).all()) and bool((h >= 0).all())
    # 200 steps from the default seed reconstruct better than 3 steps.
    err = lambda w, h: float(torch.linalg.norm(t(x) - w @ h))  # noqa: E731
    assert err(w, h) < err(*a)


@pytest.mark.parametrize("lead", [(), (3,)])
def test_nmf_transform_matches_jax(lead):
    x, _, h0 = _data(seed=1, lead=lead)
    got = tnmf.nmf_transform(t(x), t(h0))
    jfn = jnmf.nmf_transform if not lead else jax.vmap(jnmf.nmf_transform)
    want = jfn(jnp.asarray(x), jnp.asarray(h0))
    assert got.shape == want.shape
    _close(got, want)


def test_cost_matrix_and_projections_match_jax():
    rng = np.random.RandomState(2)
    p1, p2 = rng.rand(5, 16).astype(np.float32), rng.rand(7, 16).astype(np.float32)
    _close(tot.build_moving_cost_matrix(t(p1), t(p2)), jot.build_moving_cost_matrix(p1, p2), 1e-6)
    x0 = rng.randn(5, 7).astype(np.float32)
    _close(tot.projection_sum_equal(t(x0), 1.0), jot.projection_sum_equal(jnp.asarray(x0), 1.0),
           1e-6)
    lo, hi = np.zeros(5, np.float32), np.full(5, 0.2, np.float32)
    _close(tot.projection_column_sum_in_range(t(x0), t(lo), t(hi)),
           jot.projection_column_sum_in_range(jnp.asarray(x0), lo, hi), 1e-6)


def test_ot_admm_matches_jax_with_equal_iterations():
    """Equal up to two iterations: the stop test compares float32 residual
    norms with a threshold, and the two frameworks' sums differ in the last
    bits."""
    rng = np.random.RandomState(0)
    p1 = np.abs(rng.randn(3, 5, 16)).astype(np.float32)
    p2 = np.abs(rng.randn(3, 5, 16)).astype(np.float32)
    plan, info = tot.ot_admm(t(p1), t(p2), return_info=True)
    jplan, jinfo = jax.vmap(lambda a, b: jot.ot_admm(a, b, return_info=True))(
        jnp.asarray(p1), jnp.asarray(p2))
    np.testing.assert_allclose(info["iterations"].numpy(), np.asarray(jinfo["iterations"]),
                               rtol=0, atol=2)
    assert bool(info["converged"].all())
    _close(plan, jplan)
    _close(tot.transform_palette(t(p1), t(p2), plan),
           jax.vmap(jot.transform_palette)(p1, p2, jplan))
    # Each problem of a stack stops on its own test and is frozen from then on.
    one = tot.ot_admm(t(p1[2]), t(p2[2]))
    assert torch.equal(one, plan[2])
    assert abs(float(plan[0].sum()) - 1.0) < 1e-2


def test_ot_admm_stops_at_the_iteration_cap():
    rng = np.random.RandomState(3)
    p1, p2 = rng.rand(4, 8).astype(np.float32), rng.rand(4, 8).astype(np.float32)
    _, info = tot.ot_admm(t(p1), t(p2), miter=10, return_info=True)
    _, jinfo = jot.ot_admm(p1, p2, miter=10, return_info=True)
    assert int(info["iterations"]) == int(jinfo["iterations"]) == 11
    assert not bool(info["converged"])


def test_compute_permutation_matches_jax(capsys):
    rng = np.random.RandomState(4)
    w1, w2 = rng.rand(5, 16).astype(np.float32), rng.rand(10, 16).astype(np.float32)
    got = tot.compute_permutation(w1, w2, verbose=True)
    assert "OT ADMM:" in capsys.readouterr().out
    want = jot.compute_permutation(w1, w2)
    assert isinstance(got, np.ndarray) and got.shape == want.shape == (5, 16)
    _close(got, want)


def test_transform_matches_jax(tmp_path, capsys):
    """The reference's feature transform: projection on the source palette
    and reconstruction, with the palette plots written when asked for."""
    rng = np.random.RandomState(5)
    enc = np.abs(rng.randn(1, 48, 8)).astype(np.float32)
    ws, wt = rng.rand(3, 8).astype(np.float32), rng.rand(3, 8).astype(np.float32)
    got = tnmf.transform(enc, ws, wt, 3)
    out = capsys.readouterr().out
    assert "Error for ws * h_ = enc" in out and "difference between two matrices" in out
    want = jnmf.transform(enc, ws, wt, 3)
    assert got.shape == want.shape == (1, 48, 8)
    _close(got, want)
    tnmf.transform(enc, ws, wt, 3, figdir=str(tmp_path))
    assert (tmp_path / "ws-wt.png").exists() and (tmp_path / "ws.npy").exists()
