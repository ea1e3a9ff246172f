"""Port per-layer encoder block (ops/encoder.py) vs the JAX fused encoder
block (ops/pallas_encoder.py, Pallas in interpret mode).

On the CPU the port runs the plain versions of K7f/K7b; JAX runs its Pallas
kernels in interpret mode. Shapes as tests/test_pallas_encoder.py: T=256,
C=8, float32, dilations 1, 8, 32 and 64 (a quarter of the clip).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import interpret_mode, n, t  # noqa: F401

from audio_style_transfer_tpu.ops.pallas_encoder import (
    fused_encoder_block as jax_block,
)
from audio_style_transfer_tpu_torch.ops import _build, encoder

# Float32 sums of the same products taken in different orders.
RTOL, ATOL = 1e-5, 1e-5
DILATIONS = [1, 8, 32, 64]


def _inputs(tl=256, c=8, seed=0, batch=None):
    rng = np.random.RandomState(seed)
    shape = (tl, c) if batch is None else (batch, tl, c)
    return (rng.randn(*shape).astype(np.float32),
            (rng.randn(3, c, c) * 0.2).astype(np.float32),
            (rng.randn(c) * 0.1).astype(np.float32),
            (rng.randn(1, c, c) * 0.2).astype(np.float32),
            (rng.randn(c) * 0.1).astype(np.float32))


def _target(shape, seed=9):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.usefixtures("interpret_mode")
@pytest.mark.parametrize("d", DILATIONS)
def test_forward_matches_jax(d):
    arrs = _inputs(seed=d)
    want = jax_block(*[jnp.asarray(a) for a in arrs], d)
    got = encoder.fused_encoder_block(*[t(a) for a in arrs], d)
    assert got.shape == (256, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(n(got), n(want), rtol=RTOL, atol=ATOL)


@pytest.mark.usefixtures("interpret_mode")
@pytest.mark.parametrize("d", DILATIONS)
def test_input_and_weight_gradients_match_jax(d):
    """dx (K7b's plain version) and the recomputed weight cotangents of
    sum((block - target)^2)."""
    arrs = _inputs(seed=10 + d)
    tgt = _target(arrs[0].shape)

    def jloss(*ws):
        return jnp.sum((jax_block(*ws, d) - jnp.asarray(tgt)) ** 2)

    want = jax.grad(jloss, argnums=tuple(range(5)))(*[jnp.asarray(a) for a in arrs])
    ts = [t(a).requires_grad_(True) for a in arrs]
    loss = torch.sum((encoder.fused_encoder_block(*ts, d) - t(tgt)) ** 2)
    got = torch.autograd.grad(loss, ts)
    for name, g, w in zip(("x", "w_dil", "b_dil", "w_res", "b_res"), got, want):
        assert float(np.abs(n(w)).max()) > 0, f"degenerate test: {name} grad ~ 0"
        scale = float(np.abs(n(w)).max())
        np.testing.assert_allclose(n(g), n(w), rtol=RTOL, atol=ATOL * scale, err_msg=name)


@pytest.mark.usefixtures("interpret_mode")
def test_batched_clips_match_one_clip_at_a_time():
    """[B, T, C] runs as one flattened call whose reads stop at clip edges:
    each clip equals its own single-clip result, and JAX's vmap of the block."""
    x, *ws = _inputs(tl=512, seed=21)
    xb = np.stack([x, x[::-1], x * 2.0])
    d = 16
    tgt = _target(xb.shape, seed=22)
    xt = t(xb).requires_grad_(True)
    out_b = encoder.fused_encoder_block(xt, *[t(w) for w in ws], d)
    (gb,) = torch.autograd.grad(torch.sum((out_b - t(tgt)) ** 2), xt)
    want = jax.vmap(lambda z: jax_block(z, *[jnp.asarray(w) for w in ws], d))(jnp.asarray(xb))
    np.testing.assert_allclose(n(out_b), n(want), rtol=RTOL, atol=ATOL)
    for lane in range(3):
        xs = t(xb[lane]).requires_grad_(True)
        single = encoder.fused_encoder_block(xs, *[t(w) for w in ws], d)
        (gs,) = torch.autograd.grad(torch.sum((single - t(tgt[lane])) ** 2), xs)
        np.testing.assert_allclose(n(out_b[lane]), n(single), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(n(gb[lane]), n(gs), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("d", [1, 7, 100])
def test_plain_backward_matches_autograd_of_the_reference(d):
    """K7b's plain version on flattened clips against autograd through the
    unfused composition, with a dilation that reaches past clip edges."""
    x, wd, bd, wr, br = _inputs(tl=128, seed=30 + d, batch=3)
    g = _target(x.shape, seed=31)
    xt = t(x).requires_grad_(True)
    out = encoder.reference_encoder_block(xt, t(wd), t(bd), t(wr), t(br), d)
    (want,) = torch.autograd.grad(out, xt, t(g))
    got = encoder.block_bwd_plain(t(x).reshape(-1, 8), t(g).reshape(-1, 8), t(wd), t(bd),
                                  t(wr[0]), d, 128)
    np.testing.assert_allclose(n(got).reshape(x.shape), n(want), rtol=RTOL, atol=ATOL)
    fwd = encoder.block_fwd_plain(t(x).reshape(-1, 8), t(wd), t(bd), t(wr[0]), t(br), d, 128)
    np.testing.assert_allclose(n(fwd).reshape(x.shape), n(out), rtol=RTOL, atol=ATOL)


def test_cpu_path_launches_no_kernel():
    _build.reset_launches()
    arrs = _inputs()
    ts = [t(a).requires_grad_(True) for a in arrs]
    encoder.fused_encoder_block(*ts, 4).sum().backward()
    assert not any(_build.LAUNCHES.values()), _build.LAUNCHES


def test_non_cpu_non_cuda_tensor_raises():
    """The wrappers never fall back: a tensor that is not on the CPU must be
    on CUDA, or the call raises."""
    c = encoder.WIDTH
    x = torch.zeros((128, c), device="meta")
    w3 = torch.zeros((3, c, c), device="meta")
    w = torch.zeros((c, c), device="meta")
    b = torch.zeros((c,), device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        encoder.block_fwd(x, w3, b, w, b, 1, 128)
    with pytest.raises(RuntimeError, match="CUDA"):
        encoder.block_bwd(x, x, w3, b, w, 1, 128)
