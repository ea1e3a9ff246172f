"""The port's full-stack transfer vs the JAX package at toy geometry.

WaveNetAEConfig(ae_num_layers=18, ae_width=16), T=4096, float32 on the CPU,
``stack=None``: every trunk tap is a style tap (L=18 > 15, so the gram
backward takes the K6 route on both sides) and the content tap is the last
layer. Both trunk flavours of the port (the chained trunk and the per-layer
blocks, ``fused_encoder=True, chain_encoder=False``) run their plain
versions here. JAX runs its gram kernels and, for the per-layer flavour, its
fused encoder blocks in Pallas interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import interpret_mode, jax_params_np, n, t, torch_params  # noqa: F401

from audio_style_transfer_tpu.models.wavenet_ae import WaveNetAEConfig as JCfg
from audio_style_transfer_tpu.signal.mu_law import mu_law_numpy
from audio_style_transfer_tpu.transfer import engine as jengine
from audio_style_transfer_tpu.transfer import losses as jlosses
from audio_style_transfer_tpu_torch.models.wavenet_ae import WaveNetAEConfig as TCfg
from audio_style_transfer_tpu_torch.transfer import engine as tengine
from audio_style_transfer_tpu_torch.transfer import grams as tgrams
from audio_style_transfer_tpu_torch.transfer import losses as tlosses

GEOM = dict(ae_num_layers=18, ae_width=16)
T = 4096
STYLE, CONT = tuple(range(18)), (17,)
# f32 on the CPU: the same float32 arithmetic summed in different orders.
RTOL = ATOL = 1e-5
# flavour -> (JAX config flags, port config flags)
FLAVOURS = {
    "chained": (dict(fused_encoder=False, chain_encoder=False), dict()),
    "per-layer": (dict(fused_encoder=True, chain_encoder=False),
                  dict(fused_encoder=True, chain_encoder=False)),
}


@pytest.fixture(scope="module")
def setup():
    pnp = jax_params_np(**GEOM)
    jp = jax.tree.map(jnp.asarray, pnp)
    rng = np.random.RandomState(0)
    audio = (0.3 * np.sin(np.arange(T) * 0.05) + 0.05 * rng.randn(T)).astype(np.float32)
    other = mu_law_numpy(0.2 * rng.randn(1, T)).astype(np.float32)
    spec = jlosses.LossSpec(cont_lyr_ids=CONT, style_layer_ids=STYLE)
    phi_c, phi_s = jlosses.transfer_embeds(jp, jnp.asarray(other), JCfg(**GEOM), spec)
    return dict(jp=jp, tp=torch_params(pnp), audio=audio,
                xq=mu_law_numpy(audio)[None].astype(np.float32),
                phi_c=np.asarray(phi_c), phi_s=np.asarray(phi_s))


def test_style_layers_of_the_full_stack():
    assert tgrams.select_style_layers(18, None) == list(STYLE)
    assert tgrams.select_style_layers(30, None) == list(range(30))


@pytest.mark.usefixtures("interpret_mode")
@pytest.mark.parametrize("flavour", list(FLAVOURS))
def test_embeds_loss_and_waveform_gradient_match_jax(setup, flavour):
    s = setup
    jflags, tflags = FLAVOURS[flavour]
    jcfg, tcfg = JCfg(**GEOM, **jflags), TCfg(**GEOM, **tflags)
    spec_j = jlosses.LossSpec(cont_lyr_ids=CONT, style_layer_ids=STYLE, fused_gram=True)
    spec_t = tlosses.LossSpec(cont_lyr_ids=CONT, style_layer_ids=STYLE)

    cj, sj = jlosses.transfer_embeds(s["jp"], jnp.asarray(s["xq"]), jcfg, spec_j)
    ct, st = tlosses.transfer_embeds(s["tp"], t(s["xq"]), tcfg, spec_t)
    assert st.shape == (16, 18, 18)
    np.testing.assert_allclose(n(ct), n(cj), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(n(st), n(sj), rtol=RTOL, atol=ATOL)

    def jloss(x):
        return jlosses.transfer_loss(s["jp"], x[None], jnp.asarray(s["phi_c"]),
                                     jnp.asarray(s["phi_s"]), jcfg, spec_j)

    (fj, pj), gj = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jnp.asarray(s["xq"][0]))
    xt = t(s["xq"][0]).requires_grad_(True)
    ft, pt = tlosses.transfer_loss(s["tp"], xt[None], t(s["phi_c"]), t(s["phi_s"]), tcfg, spec_t)
    (gt,) = torch.autograd.grad(ft, xt)
    for k in ("loss", "content_loss", "style_loss"):
        np.testing.assert_allclose(n(pt[k]), n(pj[k]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(n(gt), n(gj), rtol=RTOL, atol=ATOL * float(np.abs(gj).max()))


@pytest.mark.parametrize("flavour", list(FLAVOURS))
def test_engine_two_epochs_match_jax(setup, flavour):
    """2 epochs at maxiter 5 (no early stop) of the full stack from the
    content clip, each port flavour against the JAX engine's XLA path:
    identical evaluation counts, and per-epoch metrics within rtol 1e-3 or
    within 1e-6 of the total loss.

    Not from the engine's 1e-6 start: there the first step is scaled by
    1/||g||_1 and float32 summation-order differences grow fast at this
    geometry (the epoch-1 total losses are 1.3e-6 apart, relative, after one
    iteration and 1.3e-3 after five; ROADMAP queue 3). The absolute term covers
    the style loss of epoch 2 (~7e-4 against a total of ~111, both sides
    1.1e-5 apart): it sits at the float32 resolution of the objective the
    optimiser sees (6e-8 of it), where the two trajectories are free to part.
    """
    s = setup
    _, tflags = FLAVOURS[flavour]
    kw = dict(stack=None, cont_lyr_ids=CONT, batch_size=T, epochs=2, maxiter=5,
              early_stop_evals=0, write_artifacts=False)
    jeng = jengine.StyleTransfer(jengine.TransferSpec(fused_encoder=False, **kw),
                                 s["jp"], JCfg(**GEOM))
    teng = tengine.StyleTransfer(tengine.TransferSpec(device="cpu", **tflags, **kw),
                                 s["tp"], TCfg(**GEOM))
    assert teng.loss_spec.style_layer_ids == STYLE
    assert teng.cfg.fused_encoder == bool(tflags) and not teng.cfg.chain_encoder
    x0 = s["audio"][None]
    jr = jeng.optimize(s["phi_c"], s["phi_s"], x0=jnp.asarray(x0))
    tr = teng.optimize(s["phi_c"], s["phi_s"], x0=x0)
    assert tr["epochs_done"] == jr["epochs_done"] == 2
    assert tr["evals"].tolist() == np.asarray(jr["evals"]).tolist()
    want = np.asarray(jr["metrics"])
    np.testing.assert_allclose(tr["metrics"], want, rtol=1e-3, atol=1e-6 * float(want[:, 0].max()))
    assert tr["metrics"][1, 0] <= tr["metrics"][0, 0]


@pytest.mark.parametrize("fused,chain,per_layer", [
    (False, None, False), (True, None, False), (True, False, True),
    (True, True, False), (False, False, False)])
def test_engine_resolves_the_trunk_flavour_as_jax(setup, fused, chain, per_layer):
    """chain_encoder None follows fused_encoder (JAX engine.py:96-106); only
    fused_encoder=True with chain_encoder=False runs the per-layer blocks."""
    spec = tengine.TransferSpec(stack=None, batch_size=T, fused_encoder=fused,
                                chain_encoder=chain, device="cpu")
    cfg = tengine.StyleTransfer(spec, setup["tp"], TCfg(**GEOM)).cfg
    assert (cfg.fused_encoder and not cfg.chain_encoder) == per_layer
