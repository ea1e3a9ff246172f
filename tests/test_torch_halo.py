"""The port's single-device exact loss (parallel/halo.py) vs the JAX package.

Toy geometry: WaveNetAEConfig(ae_num_layers=6, ae_width=16) (receptive-field
radius 64, rounded up to 2048 for the scan), style layers (0, 2, 4), content
layer 5, float32 on the CPU. The JAX functions run their XLA path (the
valid window as a mask over plain convs). Each case holds, on the same
weights and inputs:
  - the port's scan loss and gradient against JAX's scan loss and gradient;
  - the scan against the single-window computation (of the unpadded clip when
    the scan masks a pad tail);
  - the two-pass ``(loss, grad)`` against plain autograd over all windows.
Tolerances: losses at rtol 2e-5 (float32 sums in another order across
windows; JAX's own scan-vs-global test uses 2e-4), gradients at rtol 1e-4
and atol 1e-5 of the largest entry, as tests/test_halo.py holds them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import jax_params_np, n, t, torch_params

from audio_style_transfer_tpu.models.wavenet_ae import WaveNetAEConfig as JCfg
from audio_style_transfer_tpu.parallel import halo as jhalo
from audio_style_transfer_tpu.transfer.losses import LossSpec as JSpec
from audio_style_transfer_tpu_torch.models import wavenet_ae as twae
from audio_style_transfer_tpu_torch.models.wavenet_ae import WaveNetAEConfig as TCfg
from audio_style_transfer_tpu_torch.ops import _build
from audio_style_transfer_tpu_torch.parallel import halo as thalo
from audio_style_transfer_tpu_torch.transfer.losses import LossSpec as TSpec

GEOM = dict(ae_num_layers=6, ae_width=16)
SPEC = dict(cont_lyr_ids=(5,), style_layer_ids=(0, 2, 4), cnt_channels=16, nb_channels=16,
            lambd=10.0)
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 2e-5, 1e-4, 1e-5

# name: (t_total, window, t_valid, gamma, gatys)
CASES = {
    "tiles, every window masked": (2048, 512, None, 0.01, False),
    "tiles, edge/middle split": (8192, 2048, None, 0.01, False),
    "pad, every window masked": (6144, 2048, 5632, 0.01, False),
    "pad, edge/middle split": (8192, 2048, 7680, 0.0, False),
    "gatys, edge/middle split": (8192, 2048, None, 0.01, True),
    "gatys, pad, every window masked": (6144, 2048, 5632, 0.0, True),
}


@pytest.fixture(scope="module")
def weights():
    pnp = jax_params_np(**GEOM)
    return jax.tree.map(jnp.asarray, pnp), torch_params(pnp)


def _case_inputs(t_total, t_valid, gatys, seed=5):
    rng = np.random.RandomState(seed)
    tv = t_total if t_valid is None else t_valid
    x = np.zeros((1, t_total), np.float32)
    x[:, :tv] = rng.uniform(-100, 100, (1, tv))
    x[:, tv:] = 17.0  # garbage in the pad tail must not leak into the loss
    phi_c = np.zeros((t_total, 16), np.float32)
    phi_c[:tv] = rng.randn(tv, 16)
    phi_s = (rng.randn(3, 16, 16) if gatys else rng.randn(16, 3, 3)).astype(np.float32) * 0.1
    return x, phi_c, phi_s, tv


def _grad_close(got, want):
    want = n(want)
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(n(got), want, rtol=GRAD_RTOL, atol=GRAD_ATOL * scale)


@pytest.mark.parametrize("name", list(CASES))
def test_scan_loss_and_gradient_match_jax_and_single_window(weights, name):
    t_total, window, t_valid, gamma, gatys = CASES[name]
    jp, tp = weights
    x, phi_c, phi_s, tv = _case_inputs(t_total, t_valid, gatys)
    jspec, tspec = JSpec(gamma=gamma, gatys=gatys, **SPEC), TSpec(gamma=gamma, gatys=gatys, **SPEC)

    jloss = jhalo.make_scan_exact_loss_fn(JCfg(**GEOM), jspec, t_total, window, t_valid)
    jf, jg = jax.jit(jax.value_and_grad(lambda xx: jloss(jp, xx, phi_c, phi_s)))(jnp.asarray(x))

    tloss = thalo.make_scan_exact_loss_fn(TCfg(**GEOM), tspec, t_total, window, t_valid)
    xt = t(x).requires_grad_(True)
    tf = tloss(tp, xt, t(phi_c), t(phi_s))
    (tg,) = torch.autograd.grad(tf, xt)
    np.testing.assert_allclose(float(tf.detach()), float(jf), rtol=LOSS_RTOL)
    _grad_close(tg, jg)
    assert not n(tg)[:, tv:].any()  # the pad tail's gradient is exactly zero

    # The two-pass (loss, grad): one window's graph at a time.
    vg = thalo.make_scan_exact_value_and_grad_fn(TCfg(**GEOM), tspec, t_total, window, t_valid)
    f2, g2 = vg(tp, t(x), t(phi_c), t(phi_s))
    assert not f2.requires_grad and g2.shape == (1, t_total)
    np.testing.assert_allclose(float(f2), float(tf.detach()), rtol=1e-6)
    _grad_close(g2, tg)
    assert not n(g2)[:, tv:].any()

    # The single-window computation of the unpadded clip.
    single = thalo._single_window_exact_loss_fn(TCfg(**GEOM), tspec, tv)
    xs = t(x[:, :tv]).requires_grad_(True)
    fs = single(tp, xs, t(phi_c[:tv]), t(phi_s))
    (gs,) = torch.autograd.grad(fs, xs)
    np.testing.assert_allclose(float(tf.detach()), float(fs.detach()), rtol=LOSS_RTOL)
    _grad_close(tg[:, :tv], gs)


def test_scan_geometry_splits_as_jax_does():
    """Which windows run masked, with which static (lo, hi)."""
    mk = lambda *a: thalo._Scan(TCfg(**GEOM), TSpec(**SPEC), *a)  # noqa: E731
    s = mk(8192, 2048, 8192)
    assert (s.radius, s.split, s.edge, s.middle) == (2048, True, [0, 3], [1, 2])
    assert s.valid_window(0) == (2048, 6144) and s.valid_window(3) == (0, 4096)
    s = mk(8192, 2048, 7680)
    assert (s.split, s.edge, s.middle) == (True, [0, 2, 3], [1])
    assert s.valid_window(2) == (0, 5632) and s.valid_window(3) == (0, 3584)
    s = mk(2048, 512, 2048)  # radius > window: no window is fully valid
    assert (s.split, s.edge, s.middle) == (False, [0, 1, 2, 3], [])
    assert s.valid_window(1) == (1536, 3584)
    full = thalo._Scan(TCfg(), TSpec(), 8 * 32768, 32768, 240128)
    assert (full.radius, full.w_ext) == (4096, 40960)
    assert (full.edge, full.middle) == ([0, 7], [1, 2, 3, 4, 5, 6])


@pytest.mark.parametrize("gamma,gatys", [(0.01, False), (0.0, True)])
def test_single_window_loss_and_gradient_match_jax(weights, gamma, gatys):
    jp, tp = weights
    x, phi_c, phi_s, _ = _case_inputs(4096, None, gatys, seed=7)
    jspec = JSpec(gamma=gamma, gatys=gatys, **SPEC)
    jloss = jhalo._single_window_exact_loss_fn(JCfg(**GEOM), jspec, 4096)
    jf, jg = jax.jit(jax.value_and_grad(lambda xx: jloss(jp, xx, phi_c, phi_s)))(jnp.asarray(x))
    tspec = TSpec(gamma=gamma, gatys=gatys, **SPEC)
    vg = thalo.make_scan_exact_value_and_grad_fn(TCfg(**GEOM), tspec, 4096, window=4096)
    tf, tg = vg(tp, t(x), t(phi_c), t(phi_s))
    np.testing.assert_allclose(float(tf), float(jf), rtol=LOSS_RTOL)
    _grad_close(tg, jg)
    # window >= t_total hands back the single-window loss itself.
    same = thalo.make_scan_exact_loss_fn(TCfg(**GEOM), tspec, 4096, window=8192)
    np.testing.assert_allclose(float(same(tp, t(x), t(phi_c), t(phi_s))), float(tf), rtol=1e-6)


@pytest.mark.parametrize("t_total,window,t_valid,gatys", [(8192, 2048, None, False),
                                                          (6144, 2048, 5632, False),
                                                          (6144, 2048, 5632, True),
                                                          (4096, 4096, None, False)])
def test_embeds_match_jax(weights, t_total, window, t_valid, gatys):
    """The target-building companion: content embed (zero over the pad) and
    the normalized global gram, rtol = atol = 1e-5 on the embed (the slice
    tests' tolerance), rtol 2e-5 on the gram."""
    jp, tp = weights
    x, _, _, tv = _case_inputs(t_total, t_valid, gatys, seed=9)
    jc, jg = jax.jit(jhalo.make_scan_exact_embeds_fn(
        JCfg(**GEOM), JSpec(gatys=gatys, **SPEC), t_total, window, t_valid))(jp, jnp.asarray(x))
    with torch.no_grad():
        tc, tg = thalo.make_scan_exact_embeds_fn(
            TCfg(**GEOM), TSpec(gatys=gatys, **SPEC), t_total, window, t_valid)(tp, t(x))
    assert tc.shape == (t_total, 16)
    np.testing.assert_allclose(n(tc), n(jc), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(tg), n(jg), rtol=2e-5, atol=1e-7)
    assert not n(tc)[tv:].any()


@pytest.mark.parametrize("gatys", [False, True])
def test_window_grams_match_jax(weights, gatys):
    jp, tp = weights
    rng = np.random.RandomState(11)
    taps = {i: rng.randn(1, 640, 16).astype(np.float32) for i in (0, 2, 4)}
    jspec, tspec = JSpec(gatys=gatys, **SPEC), TSpec(gatys=gatys, **SPEC)
    want = jhalo._window_grams({i: jnp.asarray(v) for i, v in taps.items()}, jspec)
    got = thalo._window_grams({i: t(v) for i, v in taps.items()}, tspec)
    assert got.dtype == torch.float32
    assert got.shape == ((3, 16, 16) if gatys else (16, 3, 3))
    np.testing.assert_allclose(n(got), n(want), rtol=1e-5, atol=1e-4)
    # bfloat16 taps: float32 sums of the bfloat16 values.
    got16 = thalo._window_grams({i: t(v, torch.bfloat16) for i, v in taps.items()}, tspec)
    want16 = thalo._window_grams({i: t(v, torch.bfloat16).float() for i, v in taps.items()}, tspec)
    assert got16.dtype == torch.float32
    np.testing.assert_allclose(n(got16), n(want16), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kwargs", [GEOM, {}], ids=["toy", "full"])
@pytest.mark.parametrize("align", [512, 2048])
def test_window_radius_equals_jax(kwargs, align):
    got = thalo._window_radius(TCfg(**kwargs), align=align)
    assert got == jhalo._window_radius(JCfg(**kwargs), align=align)
    assert got % align == 0 and got >= twae.receptive_field_radius(TCfg(**kwargs))
    if not kwargs:
        assert got == {512: 3072, 2048: 4096}[align]


def test_make_functions_refuse_what_jax_refuses():
    cfg, spec = TCfg(**GEOM), TSpec(gamma=0.01, **SPEC)
    for make in (thalo.make_scan_exact_loss_fn, thalo.make_scan_exact_value_and_grad_fn,
                 thalo.make_scan_exact_embeds_fn):
        with pytest.raises(ValueError, match="tile into 512-aligned"):
            make(cfg, spec, 5000, 2048)
        with pytest.raises(ValueError, match="tile into 512-aligned"):
            make(cfg, spec, 3000, 1000)
        with pytest.raises(ValueError, match="outside"):
            make(cfg, spec, 4096, 2048, t_valid=5000)
        with pytest.raises(ValueError, match="no pad masking"):
            make(cfg, spec, 4096, 4096, t_valid=4000)
    # gamma != 0 with t_valid shorter than one STFT frame would divide by zero.
    with pytest.raises(ValueError, match="STFT frame"):
        thalo.make_scan_exact_loss_fn(cfg, spec, t_total=1024, window=512, t_valid=512)
    thalo.make_scan_exact_loss_fn(cfg, dataclasses.replace(spec, gamma=0.0), t_total=1024,
                                  window=512, t_valid=512)


def test_cpu_scan_launches_no_kernel(weights):
    _, tp = weights
    x, phi_c, phi_s, _ = _case_inputs(2048, None, False)
    _build.reset_launches()
    vg = thalo.make_scan_exact_value_and_grad_fn(TCfg(**GEOM), TSpec(**SPEC), 2048, 512)
    vg(tp, t(x), t(phi_c), t(phi_s))
    assert not any(_build.LAUNCHES.values()), _build.LAUNCHES
