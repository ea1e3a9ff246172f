"""Port per-layer encoder block (ops/encoder.py) vs the JAX fused encoder
block (ops/pallas_encoder.py, Pallas in interpret mode).

On the CPU the port runs the plain versions of K7f/K7b; JAX runs its Pallas
kernels in interpret mode. Shapes as tests/test_pallas_encoder.py: T=256,
C=8, float32, dilations 1, 8, 32 and 64 (a quarter of the clip). Under a
valid window JAX has no kernel: its per-layer path runs the masked XLA block
``masked(enc + d)`` (models/wavenet_ae.py::encoder_trunk), which is the
oracle of the windowed plain versions and of the per-layer trunk.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import interpret_mode, jax_params_np, n, t, torch_params  # noqa: F401

from audio_style_transfer_tpu.models import wavenet_ae as jwae
from audio_style_transfer_tpu.ops.pallas_encoder import (
    fused_encoder_block as jax_block,
)
from audio_style_transfer_tpu.ops.pallas_encoder import (
    reference_encoder_block as jax_reference_block,
)
from audio_style_transfer_tpu_torch.models import wavenet_ae as twae
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


# Valid windows of a 256-row clip: both edges inside it, from 0, to the end,
# clamped past both ends.
WINDOWS = [(37, 200), (0, 100), (150, 256), (-20, 300)]


@pytest.mark.parametrize("vw", WINDOWS)
@pytest.mark.parametrize("d", [1, 64])
def test_windowed_plain_versions_match_the_jax_masked_block(vw, d):
    """K7f's and K7b's plain versions under a window against the JAX
    per-layer path's masked block (its XLA reference block times the window)
    and that block's VJP; masked rows of the output are exactly zero."""
    x, wd, bd, wr, br = _inputs(seed=40 + d)
    g = _target(x.shape, seed=41)
    lo, hi = max(vw[0], 0), min(vw[1], 256)
    inside = ((np.arange(256) >= lo) & (np.arange(256) < hi)).astype(np.float32)[:, None]
    ws = [jnp.asarray(a) for a in (wd, bd, wr, br)]
    want, vjp = jax.vjp(lambda z: jax_reference_block(z, *ws, d) * inside, jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    args = (t(wd), t(bd), t(wr[0]))
    got = encoder.block_fwd_plain(t(x), *args, t(br), d, 256, vw)
    got_dx = encoder.block_bwd_plain(t(x), t(g), *args, d, 256, vw)
    assert not n(got)[:lo].any() and not n(got)[hi:].any()
    np.testing.assert_allclose(n(got), n(want), rtol=RTOL, atol=ATOL)
    scale = float(np.abs(n(want_dx)).max())
    np.testing.assert_allclose(n(got_dx), n(want_dx), rtol=RTOL, atol=ATOL * scale)


def test_full_range_window_is_bit_equal_to_no_window():
    """[0, T) and a window clamped to it: the plain versions and the block's
    autograd (forward, dx, weight cotangents) equal no window bit for bit;
    on two flattened clips the window applies per clip."""
    x, wd, bd, wr, br = _inputs(tl=256, seed=50, batch=2)
    g = _target(x.shape, seed=51)
    flat = (t(x).reshape(-1, 8), t(wd), t(bd), t(wr[0]))
    fwd = encoder.block_fwd_plain(*flat, t(br), 4, 256)
    bwd = encoder.block_bwd_plain(flat[0], t(g).reshape(-1, 8), *flat[1:], 4, 256)
    base = None
    for vw in (None, (0, 256), (-3, 260)):
        assert torch.equal(encoder.block_fwd_plain(*flat, t(br), 4, 256, vw), fwd)
        assert torch.equal(encoder.block_bwd_plain(flat[0], t(g).reshape(-1, 8), *flat[1:], 4,
                                                   256, vw), bwd)
        ts = [t(a).requires_grad_(True) for a in (x, wd, bd, wr, br)]
        out = encoder.fused_encoder_block(*ts, 4, valid_window=vw)
        grads = (out,) + torch.autograd.grad(out, ts, t(g))
        base = base or grads
        assert all(torch.equal(a, b) for a, b in zip(grads, base))
    both = encoder.block_fwd_plain(*flat, t(br), 4, 256, (30, 90))
    for k in range(2):
        one = encoder.block_fwd_plain(flat[0][k * 256:(k + 1) * 256], *flat[1:], t(br), 4, 256,
                                      (30, 90))
        assert torch.equal(both[k * 256:(k + 1) * 256], one)


# 3 trunk layers of width 8 (dilations 1, 2, 4), bottleneck 4.
CFG3 = dict(ae_num_layers=3, ae_num_stages=3, ae_width=8, ae_bottleneck_width=4, num_layers=2,
            width=8, skip_width=8)


@pytest.mark.parametrize("vw", [(96, 416), (0, 300), (200, 512), (-50, 600)])
def test_per_layer_encoder_trunk_under_a_window_matches_jax(vw):
    """``encoder_trunk`` in the per-layer flavour with a valid window (start
    conv masked, then the windowed K7f / K7b plain versions) against JAX's
    masked XLA trunk in the same flavour: every extract, and the gradient of
    the quantized input through all of them. float32; extracts at rtol =
    atol = 1e-5, the gradient at atol 1e-5 of its largest entry (the same
    float32 products summed in other orders)."""
    pnp = jax_params_np(**CFG3)
    rng = np.random.RandomState(7)
    xq = rng.randint(-128, 128, (1, 512)).astype(np.float32)
    flags = dict(fused_encoder=True, chain_encoder=False)
    jcfg, tcfg = jwae.WaveNetAEConfig(**CFG3, **flags), twae.WaveNetAEConfig(**CFG3, **flags)
    jparams = jax.tree.map(jnp.asarray, pnp)
    want = jwae.encoder_trunk(jparams, jnp.asarray(xq), jcfg, valid_window=vw)
    cts = [rng.randn(*np.shape(e)).astype(np.float32) for e in want]

    def jloss(z):
        extracts = jwae.encoder_trunk(jparams, z, jcfg, valid_window=vw)
        return sum(jnp.sum(e * c) for e, c in zip(extracts, cts))

    want_g = jax.grad(jloss)(jnp.asarray(xq))
    xt = t(xq).requires_grad_(True)
    got = twae.encoder_trunk(torch_params(pnp), xt, tcfg, valid_window=vw)
    (got_g,) = torch.autograd.grad(got, xt, [t(c) for c in cts])
    assert len(got) == len(want) == 5
    lo, hi = max(vw[0], 0), min(vw[1], 512)
    for i in range(5):
        np.testing.assert_allclose(n(got[i]), n(want[i]), rtol=1e-5, atol=1e-5,
                                   err_msg=f"extract {i}")
        if i < 4:
            assert not n(got[i])[0, :lo].any() and not n(got[i])[0, hi:].any()
    scale = float(np.abs(n(want_g)).max())
    assert scale > 0
    np.testing.assert_allclose(n(got_g), n(want_g), rtol=1e-5, atol=1e-5 * scale)
