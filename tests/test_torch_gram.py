"""Port gram (ops/gram.py) vs the JAX all-pairs gram (Pallas, interpret mode).

On the CPU the port's forward runs its plain einsum and the backward the
plain composition; JAX runs its forward kernel, and its backward kernel (K6)
for L > 15 (the L=16, 18 and 30 cases) and for T > 32768, in interpret mode.
f32, T=256, C=16 (C=8 past the T gate).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import interpret_mode, n, t  # noqa: F401

from audio_style_transfer_tpu.ops.pallas_gram import pair_gram as jax_pair_gram
from audio_style_transfer_tpu_torch.ops import _build, gram

# Sums of 256 float32 products taken in different orders.
RTOL, ATOL = 1e-5, 1e-5


def _taps(nl, b=1, tl=256, c=16, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, tl, c).astype(np.float32) for _ in range(nl)]


@pytest.mark.usefixtures("interpret_mode")
@pytest.mark.parametrize("nl", [3, 10, 16, 18, 30])
def test_forward_and_grad_match_jax(nl):
    taps = _taps(nl)
    ct = np.random.RandomState(7).randn(1, nl, nl, 16).astype(np.float32)

    want = jax_pair_gram(*[jnp.asarray(a) for a in taps])
    want_grads = jax.grad(
        lambda *ts: jnp.sum(jax_pair_gram(*ts) * ct), argnums=tuple(range(nl))
    )(*[jnp.asarray(a) for a in taps])

    tt = [t(a).requires_grad_(True) for a in taps]
    got = gram.pair_gram(*tt)
    assert got.shape == (1, nl, nl, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(n(got), n(want), rtol=RTOL, atol=ATOL)
    grads = torch.autograd.grad(got, tt, t(ct))
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(n(g), n(w), rtol=RTOL, atol=ATOL)


@pytest.mark.usefixtures("interpret_mode")
def test_backward_past_the_t_gate_matches_jax():
    """L=2 but T > 32768: JAX runs its backward kernel there too."""
    tl = 32768 + 128
    taps = _taps(2, tl=tl, c=8, seed=3)
    ct = np.random.RandomState(8).randn(1, 2, 2, 8).astype(np.float32)
    want = jax.grad(lambda a, b: jnp.sum(jax_pair_gram(a, b) * ct), argnums=(0, 1))(
        *[jnp.asarray(a) for a in taps])
    tt = [t(a).requires_grad_(True) for a in taps]
    got = torch.autograd.grad(gram.pair_gram(*tt), tt, t(ct))
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), n(w), rtol=RTOL, atol=ATOL * float(np.abs(n(w)).max()))


@pytest.mark.parametrize("nl,tl,routed", [(15, 64, False), (16, 64, True),
                                          (2, 32768, False), (2, 32769, True)])
def test_backward_routing_follows_jax(monkeypatch, nl, tl, routed):
    """The plain composition for L <= 15 and T <= 32768 (pallas_gram.py
    _vjp_bwd), ``pair_gram_bwd`` (K6 on CUDA) everywhere else."""
    calls = []
    real = gram.pair_gram_bwd
    monkeypatch.setattr(gram, "pair_gram_bwd", lambda taps, h: calls.append(1) or real(taps, h))
    tt = [t(a).requires_grad_(True) for a in _taps(nl, tl=tl, c=8)]
    grads = torch.autograd.grad(gram.pair_gram(*tt).sum(), tt)
    assert len(calls) == int(routed)
    want = gram.pair_gram_bwd_plain([x.detach() for x in tt],
                                    torch.full((1, nl, nl, 8), 2.0))
    for g, w in zip(grads, want):
        np.testing.assert_allclose(n(g), n(w), rtol=RTOL, atol=ATOL)


def test_cpu_path_launches_no_kernel():
    _build.reset_launches()
    tt = [t(a).requires_grad_(True) for a in _taps(30, tl=64, c=8)]
    torch.autograd.grad(gram.pair_gram(*tt).sum(), tt)
    assert not any(_build.LAUNCHES.values()), _build.LAUNCHES


def test_batched_and_bf16_products_in_f32():
    """Batch rows are independent grams; bf16 taps are multiplied in f32
    (bf16 x bf16 products are exact in f32), so they match the f32 gram of
    the bf16-rounded taps."""
    taps = _taps(4, b=2)
    bf = [t(a, torch.bfloat16) for a in taps]
    got = gram.pair_gram(*bf)
    want = gram.pair_gram_reference(*[b.float() for b in bf])
    np.testing.assert_allclose(n(got), n(want), rtol=RTOL, atol=ATOL)
    for b in range(2):
        single = gram.pair_gram(*[tp[b : b + 1] for tp in bf])
        np.testing.assert_allclose(n(got[b]), n(single[0]), rtol=RTOL, atol=ATOL)
    g = torch.autograd.grad(gram.pair_gram(*[tp.requires_grad_(True) for tp in bf]).sum(), bf)
    assert all(x.dtype == torch.bfloat16 for x in g)


def test_kernel_checks_raise_on_bad_input():
    meta = [torch.zeros((1, 64, 24), device="meta") for _ in range(2)]
    with pytest.raises(RuntimeError, match="CUDA"):
        gram.pair_gram_fwd(*meta)
    with pytest.raises(RuntimeError, match="CUDA"):
        gram.pair_gram_bwd(meta, torch.zeros((1, 2, 2, 24), device="meta"))
