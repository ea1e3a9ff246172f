"""Port gram (ops/gram.py) vs the JAX all-pairs gram (Pallas, interpret mode).

On the CPU the port's forward runs its plain einsum and the backward the
plain composition; JAX runs its forward kernel, and its backward kernel for
L > 15 (the L=16 case), in interpret mode. f32, T=256, C=16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import interpret_mode, n, t  # noqa: F401

from audio_style_transfer_tpu.ops.pallas_gram import pair_gram as jax_pair_gram
from audio_style_transfer_tpu_torch.ops import gram

# Sums of 256 float32 products taken in different orders.
RTOL, ATOL = 1e-5, 1e-5


def _taps(nl, b=1, tl=256, c=16, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, tl, c).astype(np.float32) for _ in range(nl)]


@pytest.mark.usefixtures("interpret_mode")
@pytest.mark.parametrize("nl", [3, 10, 16])
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
