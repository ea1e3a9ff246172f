"""The valid-window trunk of the port (ops/chain.py ``valid_window=``) vs the
JAX chained trunk's windowed branch.

On the CPU the wrappers run the plain versions of the windowed K1/K2. They
are held to JAX's ``reference_trunk(valid_window=)`` (the main oracle: taps,
mask bits, waveform gradient) and, in one small case, to the windowed Pallas
``fused_trunk`` in interpret mode. float32; taps at rtol = atol = 1e-5,
gradients at rtol 1e-5 / atol 1e-4 (the tolerances of the JAX package's own
windowed test, tests/test_pallas_chain.py). Geometry: T=256, C=8,
dilations (1, 2, 4, 64).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import (  # noqa: F401
    interpret_mode,
    jax_params_np,
    n,
    t,
    torch_params,
    trunk_inputs,
)

from audio_style_transfer_tpu.models import wavenet_ae as jwae
from audio_style_transfer_tpu.ops import pallas_chain as jchain
from audio_style_transfer_tpu.ops.conv import conv1d as jconv1d
from audio_style_transfer_tpu_torch.models import wavenet_ae as twae
from audio_style_transfer_tpu_torch.ops import chain

T = 256
DILS = (1, 2, 4, 64)
EMIT = (0, 2, 3)
ALL = tuple(range(len(DILS)))
# interior (both edges cut the clip), from 0, to the end, empty, beyond the
# clip on both sides (clamped), one row.
WINDOWS = [(32, 224), (0, 100), (48, 256), (100, 100), (-40, 400), (17, 18)]


def _inputs(seed=51):
    return trunk_inputs(t=T, c=8, n=len(DILS), seed=seed)


def _cotangents(count, seed=52):
    return [np.random.RandomState(seed + i).randn(T, 8).astype(np.float32) for i in range(count)]


def _torch_grad(fn, x, w, emit, cts, vw):
    xt = t(x).requires_grad_(True)
    taps = fn(xt, *w, DILS, emit, valid_window=vw)
    (g,) = torch.autograd.grad(taps, xt, [t(c) for c in cts])
    return taps, g


@pytest.mark.parametrize("vw", WINDOWS)
def test_windowed_taps_and_gradient_match_jax_reference(vw):
    x, wd, bd, wr, br = _inputs()
    w = [t(a) for a in (wd, bd, wr, br)]
    cts = _cotangents(len(EMIT))
    jvw = jnp.asarray(vw, jnp.int32)

    def jloss(z):
        taps = jchain.reference_trunk(z, wd, bd, wr, br, DILS, EMIT, valid_window=jvw)
        return sum(jnp.sum(tp * c) for tp, c in zip(taps, cts))

    want_taps = jchain.reference_trunk(jnp.asarray(x), wd, bd, wr, br, DILS, EMIT,
                                       valid_window=jvw)
    want_g = jax.grad(jloss)(jnp.asarray(x))
    got_taps, got_g = _torch_grad(chain.fused_trunk, x, w, EMIT, cts, vw)
    ref_taps, ref_g = _torch_grad(chain.reference_trunk, x, w, EMIT, cts, vw)
    lo, hi = max(vw[0], 0), min(vw[1], T)
    for g, r, want in zip(got_taps, ref_taps, want_taps):
        assert not n(g)[:lo].any() and not n(g)[hi:].any()  # masked rows are exactly zero
        np.testing.assert_allclose(n(g), n(want), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(n(r), n(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(got_g), n(want_g), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(n(ref_g), n(want_g), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("vw", WINDOWS[:3])
def test_windowed_mask_bytes(vw):
    """Bit 0 is taken after the window multiply (a masked row's bit is 0: the
    next layer's backward gates on it), bit 1 (the gate y > 0) before it, from
    the masked input: both against JAX's reference taps and conv."""
    x, wd, bd, wr, br = _inputs()
    w = [t(a) for a in (wd, bd, wr, br)]
    jtaps = jchain.reference_trunk(jnp.asarray(x), wd, bd, wr, br, DILS, ALL,
                                   valid_window=jnp.asarray(vw, jnp.int32))
    outs, masks, inmask = chain.trunk_forward(t(x), *w, DILS, T, valid_window=vw)
    np.testing.assert_array_equal(n(inmask), x > 0)
    cur = jnp.asarray(x)
    for j, d in enumerate(DILS):
        y = jconv1d(jnp.maximum(cur, 0)[None], wd[j], bd[j], dilation=d, causal=False)[0]
        np.testing.assert_array_equal(n(masks[j] & 1), n(jtaps[j]) > 0)
        np.testing.assert_array_equal(n((masks[j] >> 1) & 1), n(y) > 0)
        np.testing.assert_allclose(n(outs[j]), n(jtaps[j]), rtol=1e-5, atol=1e-5)
        cur = jtaps[j]
    lo, hi = vw
    assert not n(masks[-1] & 1)[:lo].any() and not n(masks[-1] & 1)[hi:].any()


def test_full_range_window_is_bit_equal_to_no_window():
    x, wd, bd, wr, br = _inputs()
    w = [t(a) for a in (wd, bd, wr, br)]
    cts = _cotangents(len(EMIT))
    base_taps, base_g = _torch_grad(chain.fused_trunk, x, w, EMIT, cts, None)
    for vw in [(0, T), (-5, T + 5)]:
        taps, g = _torch_grad(chain.fused_trunk, x, w, EMIT, cts, vw)
        for a, b in zip(taps, base_taps):
            assert torch.equal(a, b)
        assert torch.equal(g, base_g)
    outs, masks, _ = chain.trunk_forward(t(x), *w, DILS, T)
    outs_w, masks_w, _ = chain.trunk_forward(t(x), *w, DILS, T, valid_window=(0, T))
    assert all(torch.equal(a, b) for a, b in zip(masks, masks_w))
    assert all(torch.equal(a, b) for a, b in zip(outs, outs_w))


@pytest.mark.usefixtures("interpret_mode")
def test_windowed_matches_pallas_kernel_in_interpret_mode():
    """One small case through the windowed Pallas kernels themselves (the
    interpret-mode backward is slow): taps and waveform gradient."""
    dils, emit, vw = (1, 2, 4), (0, 2), (32, 224)
    x, wd, bd, wr, br = trunk_inputs(t=T, c=8, n=3, seed=51)
    cts = _cotangents(2)
    jvw = jnp.asarray(vw, jnp.int32)

    def jloss(z):
        taps = jchain.fused_trunk(z, wd, bd, wr, br, dils, emit, valid_window=jvw)
        return sum(jnp.sum(tp * c) for tp, c in zip(taps, cts))

    want_taps = jchain.fused_trunk(jnp.asarray(x), wd, bd, wr, br, dils, emit, valid_window=jvw)
    want_g = jax.grad(jloss)(jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    taps = chain.fused_trunk(xt, t(wd), t(bd), t(wr), t(br), dils, emit, valid_window=vw)
    (g,) = torch.autograd.grad(taps, xt, [t(c) for c in cts])
    for a, b in zip(taps, want_taps):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(g), n(want_g), rtol=1e-5, atol=1e-4)


def test_windowed_weight_gradients_by_recompute_match_autograd():
    x, wd, bd, wr, br = _inputs()
    ct = _cotangents(1)[0]
    vw = (32, 224)
    ws = [t(a).requires_grad_(True) for a in (wd, bd, wr, br)]
    (tap,) = chain.fused_trunk(t(x), *ws, DILS, (3,), valid_window=vw)
    got = torch.autograd.grad(tap, ws, t(ct))
    wr_ = [t(a).requires_grad_(True) for a in (wd, bd, wr, br)]
    (tap_r,) = chain.reference_trunk(t(x), *wr_, DILS, (3,), valid_window=vw)
    want = torch.autograd.grad(tap_r, wr_, t(ct))
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), n(w), rtol=1e-5, atol=1e-5)


def test_layer_plain_versions_take_the_window_per_clip():
    """Two flattened clips: the window is in in-clip rows, applied to each."""
    x, wd, bd, wr, br = trunk_inputs(t=2 * T, c=8, n=1, seed=3)
    args = (t(wd[0]), t(bd[0]), t(wr[0]), t(br[0]), 2, T)
    out, mask, _ = chain.layer_fwd_plain(t(x), *args, valid_window=(10, 200))
    for b in range(2):
        one, m1, _ = chain.layer_fwd_plain(t(x[b * T:(b + 1) * T]), *args, valid_window=(10, 200))
        assert torch.equal(out[b * T:(b + 1) * T], one)
        assert torch.equal(mask[b * T:(b + 1) * T], m1)
    dxn = t(np.random.RandomState(4).randn(2 * T, 8))
    dx = chain.layer_bwd_plain(dxn, None, mask, (t(x) > 0).to(torch.uint8), t(wd[0]), t(wr[0]),
                               2, T, valid_window=(10, 200))
    both = chain.layer_bwd_plain(dxn[:T], None, mask[:T], (t(x[:T]) > 0).to(torch.uint8),
                                 t(wd[0]), t(wr[0]), 2, T, valid_window=(10, 200))
    assert torch.equal(dx[:T], both)


def test_window_with_a_batch_raises():
    x, wd, bd, wr, br = _inputs()
    w = [t(a) for a in (wd, bd, wr, br)]
    with pytest.raises(ValueError, match="one clip"):
        chain.fused_trunk(t(np.stack([x, x])), *w, DILS, EMIT, valid_window=(0, 10))
    # Batch 1 with a leading axis is one clip.
    (tap,) = chain.fused_trunk(t(x[None]), *w, DILS, (3,), valid_window=(0, 10))
    assert tap.shape == (1, T, 8)


@pytest.mark.parametrize("vw", WINDOWS)
def test_wavefront_backward_with_a_window_matches_jax_reference(vw, monkeypatch):
    """With the wavefront on, the windowed backward runs the group (1, 2, 4)
    through K2-wf's plain version with the window (the JAX kernel's multiply
    of the carry plus tap cotangent by _window_mask) and d=64 through K2's:
    JAX's reference gradient at the tolerance above, and the serial windowed
    backward bit for bit."""
    x, wd, bd, wr, br = _inputs()
    w = [t(a) for a in (wd, bd, wr, br)]
    cts = _cotangents(len(EMIT))

    def jloss(z):
        taps = jchain.reference_trunk(z, wd, bd, wr, br, DILS, EMIT,
                                      valid_window=jnp.asarray(vw, jnp.int32))
        return sum(jnp.sum(tp * c) for tp, c in zip(taps, cts))

    want_g = jax.grad(jloss)(jnp.asarray(x))
    _, serial = _torch_grad(chain.fused_trunk, x, w, EMIT, cts, vw)
    monkeypatch.setattr(chain, "_BWD_WAVEFRONT", True)
    calls = []
    plain = chain.group_bwd_plain
    monkeypatch.setattr(chain, "group_bwd_plain",
                        lambda *a: calls.append(a[10]) or plain(*a))
    _, got_g = _torch_grad(chain.fused_trunk, x, w, EMIT, cts, vw)
    assert calls == [vw], "the group (1, 2, 4) must run as one wavefront group with the window"
    np.testing.assert_allclose(n(got_g), n(want_g), rtol=1e-5, atol=1e-4)
    assert torch.equal(got_g, serial)


CFG = dict(ae_num_layers=4, ae_num_stages=4, ae_width=8, ae_bottleneck_width=4,
           num_layers=2, width=8, skip_width=8)


@pytest.mark.parametrize("vw", [(96, 416), (0, 300), (200, 512)])
def test_encoder_trunk_valid_window_matches_jax_masked_trunk(vw):
    """``encoder_trunk(valid_window=)``, start conv masking and bottleneck
    included, against the JAX trunk under the same mask (its XLA path)."""
    pnp = jax_params_np(**CFG)
    xq = np.random.RandomState(3).randint(-128, 128, (1, 512)).astype(np.float32)
    pos = np.arange(512)
    want = jwae.encoder_trunk(jax.tree.map(jnp.asarray, pnp), jnp.asarray(xq),
                              jwae.WaveNetAEConfig(**CFG),
                              valid_mask=jnp.asarray((pos >= vw[0]) & (pos < vw[1])))
    got = twae.encoder_trunk(torch_params(pnp), t(xq), twae.WaveNetAEConfig(**CFG),
                             valid_window=vw)
    assert len(got) == len(want) == 6
    for i in range(6):
        np.testing.assert_allclose(n(got[i]), n(want[i]), rtol=1e-5, atol=1e-5,
                                   err_msg=f"extract {i}")


@pytest.mark.parametrize("vw", [(96, 416), (0, 300), (200, 512)])
def test_per_layer_encoder_trunk_valid_window_matches_jax_masked_trunk(vw):
    """The per-layer flavour (fused_encoder=True, chain_encoder=False) under a
    window: the JAX package runs it as masked XLA blocks (``masked(enc +
    d)``), the port through the windowed K7f's plain version; and it equals
    the chained flavour's windowed trunk."""
    pnp = jax_params_np(**CFG)
    xq = np.random.RandomState(3).randint(-128, 128, (1, 512)).astype(np.float32)
    jcfg = jwae.WaveNetAEConfig(**CFG, fused_encoder=True, chain_encoder=False)
    want = jwae.encoder_trunk(jax.tree.map(jnp.asarray, pnp), jnp.asarray(xq), jcfg,
                              valid_window=vw)
    cfg = twae.WaveNetAEConfig(**CFG)
    per_layer = dataclasses.replace(cfg, fused_encoder=True, chain_encoder=False)
    got = twae.encoder_trunk(torch_params(pnp), t(xq), per_layer, valid_window=vw)
    chained = twae.encoder_trunk(torch_params(pnp), t(xq), cfg, valid_window=vw)
    assert len(got) == len(want) == 6
    for i in range(6):
        np.testing.assert_allclose(n(got[i]), n(want[i]), rtol=1e-5, atol=1e-5,
                                   err_msg=f"extract {i}")
        np.testing.assert_allclose(n(got[i]), n(chained[i]), rtol=1e-6, atol=1e-6,
                                   err_msg=f"extract {i}")


def test_encoder_trunk_window_refusals():
    """A window is one clip's state: a batch of clips is refused in both
    flavours."""
    pnp = jax_params_np(**CFG)
    tp = torch_params(pnp)
    cfg = twae.WaveNetAEConfig(**CFG)
    per_layer = dataclasses.replace(cfg, fused_encoder=True, chain_encoder=False)
    for flavour in (cfg, per_layer):
        with pytest.raises(ValueError, match="one clip"):
            twae.encoder_trunk(tp, torch.zeros((2, 512)), flavour, valid_window=(0, 100))


@pytest.mark.parametrize("kwargs", [CFG, {}], ids=["toy", "full"])
def test_receptive_field_radius_equals_jax(kwargs):
    got = twae.receptive_field_radius(twae.WaveNetAEConfig(**kwargs))
    assert got == jwae.receptive_field_radius(jwae.WaveNetAEConfig(**kwargs))
    if not kwargs:
        assert got == 3070
