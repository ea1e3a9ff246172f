"""Port trunk (ops/chain.py) vs the JAX chained trunk and its references.

On the CPU the port's wrappers run the plain versions of the trunk kernels
(K1 forward with masks, K2 mask-only backward); these tests hold them to the
JAX ``fused_trunk`` (Pallas, interpret mode), to ``jax.grad`` through the JAX
``reference_trunk`` and to torch autograd through the port's own
``reference_trunk``. Geometry: T=512, C=8, dilations (1, 2, 4, 8, 256).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import interpret_mode, n, t, trunk_inputs  # noqa: F401

from audio_style_transfer_tpu.ops import pallas_chain as jchain
from audio_style_transfer_tpu_torch.ops import _build, chain

DILS = (1, 2, 4, 8, 256)
EMIT = (1, 3, 4)
# f32: both sides accumulate the same float32 products, in different orders.
RTOL = ATOL = 1e-5


def _cotangents(shape, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in EMIT]


@pytest.mark.usefixtures("interpret_mode")
def test_forward_taps_match_jax():
    x, wd, bd, wr, br = trunk_inputs()
    got = chain.fused_trunk(t(x), t(wd), t(bd), t(wr), t(br), DILS, EMIT)
    want_kernel = jchain.fused_trunk(jnp.asarray(x), wd, bd, wr, br, DILS, EMIT)
    want_ref = jchain.reference_trunk(jnp.asarray(x), wd, bd, wr, br, DILS, EMIT)
    assert len(got) == len(EMIT)
    for g, wk, wf in zip(got, want_kernel, want_ref):
        np.testing.assert_allclose(n(g), n(wk), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(n(g), n(wf), rtol=RTOL, atol=ATOL)


@pytest.mark.usefixtures("interpret_mode")
def test_mask_backward_dx_matches_jax_and_autograd():
    x, wd, bd, wr, br = trunk_inputs()
    cts = _cotangents(x.shape)

    def jloss(fn):
        def f(z):
            taps = fn(z, wd, bd, wr, br, DILS, EMIT)
            return sum(jnp.sum(tp * c) for tp, c in zip(taps, cts))
        return f

    want_kernel = jax.grad(jloss(jchain.fused_trunk))(jnp.asarray(x))
    want_ref = jax.grad(jloss(jchain.reference_trunk))(jnp.asarray(x))

    xt = t(x).requires_grad_(True)
    taps = chain.fused_trunk(xt, t(wd), t(bd), t(wr), t(br), DILS, EMIT)
    (got,) = torch.autograd.grad(taps, xt, [t(c) for c in cts])

    xr = t(x).requires_grad_(True)
    taps_r = chain.reference_trunk(xr, t(wd), t(bd), t(wr), t(br), DILS, EMIT)
    (want_torch,) = torch.autograd.grad(taps_r, xr, [t(c) for c in cts])

    for want in (want_kernel, want_ref, want_torch):
        np.testing.assert_allclose(n(got), n(want), rtol=RTOL, atol=ATOL)


def test_weight_gradients_by_recompute_match_autograd():
    x, wd, bd, wr, br = trunk_inputs(n=3)
    dils = (1, 4, 16)
    cts = [np.random.RandomState(2).randn(*x.shape).astype(np.float32)]
    ws = [t(a).requires_grad_(True) for a in (wd, bd, wr, br)]
    (tap,) = chain.fused_trunk(t(x), *ws, dils, (2,))
    got = torch.autograd.grad(tap, ws, t(cts[0]))
    wr_ = [t(a).requires_grad_(True) for a in (wd, bd, wr, br)]
    (tap_r,) = chain.reference_trunk(t(x), *wr_, dils, (2,))
    want = torch.autograd.grad(tap_r, wr_, t(cts[0]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), n(w), rtol=RTOL, atol=ATOL)


def test_batched_clips_are_independent():
    """Rows of a batch flatten into one [B*T, C] array; each clip's edges
    read zeros, so a batch equals its clips run one by one."""
    x, wd, bd, wr, br = trunk_inputs(t=256)
    x2 = np.stack([x, x[::-1].copy()])
    w = [t(a) for a in (wd, bd, wr, br)]
    got = chain.fused_trunk(t(x2), *w, DILS, EMIT)
    for b in range(2):
        single = chain.fused_trunk(t(x2[b]), *w, DILS, EMIT)
        for g, s in zip(got, single):
            np.testing.assert_allclose(n(g[b]), n(s), rtol=RTOL, atol=ATOL)


def test_masks_hold_output_and_gate_bits():
    x, wd, bd, wr, br = trunk_inputs(n=1)
    out, mask, inmask = chain.layer_fwd_plain(
        t(x), t(wd[0]), t(bd[0]), t(wr[0]), t(br[0]), 2, 512, want_inmask=True)
    assert mask.dtype == torch.uint8 and inmask.dtype == torch.uint8
    np.testing.assert_array_equal(n(mask & 1), n(out > 0))
    np.testing.assert_array_equal(n(inmask), n(t(x) > 0))
    # Gate bit: y = conv3(relu x) + bd > 0, through the JAX conv.
    from audio_style_transfer_tpu.ops.conv import conv1d

    y = conv1d(jnp.maximum(jnp.asarray(x), 0)[None], wd[0], bd[0], dilation=2,
               causal=False)[0]
    np.testing.assert_array_equal(n((mask >> 1) & 1), n(y > 0))


def test_bf16_matches_jax_reference_trunk():
    """bf16: the port casts as the Pallas kernel does (y + bd in f32, then
    one rounding), while the JAX reference rounds the conv output to bf16
    before adding the bias. The two differ by a few bf16 ulps (2^-8
    relative) per layer, compounded over 5 layers of activations of order
    1-10, hence atol 0.1 and rtol 0.05 on the taps."""
    x, wd, bd, wr, br = trunk_inputs()
    bf = torch.bfloat16
    got = chain.fused_trunk(t(x, bf), t(wd, bf), t(bd, bf), t(wr, bf), t(br, bf), DILS, EMIT)
    c = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    want = jchain.reference_trunk(c(x), c(wd), c(bd), c(wr), c(br), DILS, EMIT)
    for g, w in zip(got, want):
        assert g.dtype == bf
        np.testing.assert_allclose(n(g), n(w), rtol=0.05, atol=0.1)


def test_cpu_path_launches_no_kernel():
    _build.reset_launches()
    x, wd, bd, wr, br = trunk_inputs()
    xt = t(x).requires_grad_(True)
    taps = chain.fused_trunk(xt, t(wd), t(bd), t(wr), t(br), DILS, EMIT)
    sum(tp.sum() for tp in taps).backward()
    assert {"K1", "K2", "K5"} <= set(_build.LAUNCHES)
    assert not any(_build.LAUNCHES.values()), _build.LAUNCHES


def test_non_cpu_non_cuda_tensor_raises():
    """The wrappers never fall back: a tensor that is not on the CPU must be
    on CUDA, or the call raises."""
    x = torch.zeros((128, chain.WIDTH), device="meta")
    w3 = torch.zeros((3, chain.WIDTH, chain.WIDTH), device="meta")
    w = torch.zeros((chain.WIDTH, chain.WIDTH), device="meta")
    b = torch.zeros((chain.WIDTH,), device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        chain.layer_fwd(x, w3, b, w, b, 1, 128)
    m = torch.zeros((128, chain.WIDTH), dtype=torch.uint8, device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        chain.layer_bwd(x, None, m, m, w3, w, 1, 128)
