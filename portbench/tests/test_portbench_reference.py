"""The plain reference against the program's CPU path at small sizes, in
float32: the encoder taps, the transfer loss and its waveform gradient, the
decoder's logits and NLL, and Adam + EMA steps."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import traffic_gen
from portbench.common import model_config, rel_l2, worst_leaf_gap
from portbench.reference import nsynth
from portbench.reference import train as ref_train
from portbench.reference.transfer import Loss
from portbench.tests.conftest import SMALL, small_cell
from portbench.weights import make_params

CFG = dict(small_cell("transfer_exact15s").config)


def _port_params(params):
    return {k: {n: v.clone() for n, v in e.items()} for k, e in params.items()}


def test_encoder_taps_match_the_program():
    from audio_style_transfer_tpu_torch.models.wavenet_ae import encoder_extracts

    params = make_params(CFG, 3, "cpu")
    xq = torch.as_tensor(nsynth.mu_law_floor(traffic_gen.arpeggio(traffic_gen.rng_for(3), 4096)),
                         dtype=torch.float32)[None]
    layers = range(CFG["ae_num_layers"])
    taps, encoding = nsynth.encoder(params, xq, CFG, taps=layers, encoding=True)
    extracts, port_encoding = encoder_extracts(_port_params(params), xq, model_config(CFG))
    # float32 sums in another order over 30 layers: held by relative L2.
    for k in layers:
        assert rel_l2(extracts[k], taps[k]) < 1e-5, k
    assert rel_l2(port_encoding, encoding) < 1e-5


def test_transfer_loss_and_waveform_gradient_match_the_program():
    from audio_style_transfer_tpu_torch.transfer.grams import l2_normalize
    from audio_style_transfer_tpu_torch.transfer.losses import (
        LossSpec,
        transfer_embeds,
        transfer_loss,
    )

    params = make_params(CFG, 5, "cpu", encoder_only=True)
    rng = traffic_gen.rng_for(5)
    content, style = traffic_gen.arpeggio(rng, 4096), traffic_gen.drone(rng, 8192)
    ref = Loss(params, CFG)
    phi_c, target = ref.targets(content, style, 4096)
    lspec = LossSpec(cont_lyr_ids=tuple(CFG["cont_lyr_ids"]), style_layer_ids=tuple(range(10)),
                     cnt_channels=CFG["cnt_channels"], nb_channels=CFG["nb_channels"],
                     lambd=CFG["lambd"])
    cfg = model_config(CFG)
    q = lambda a: torch.as_tensor(nsynth.mu_law_floor(a), dtype=torch.float32)[None]  # noqa: E731
    c_port, g_content = transfer_embeds(params, q(content), cfg, lspec)
    grams = [transfer_embeds(params, q(style[i * 4096:(i + 1) * 4096]), cfg, lspec)[1]
             for i in range(2)]
    target_port = l2_normalize(g_content + torch.stack(grams).mean(0) - g_content)
    assert rel_l2(c_port, phi_c) < 1e-5
    assert rel_l2(target_port, target) < 1e-5

    x = torch.as_tensor(np.linspace(-20, 20, 4096), dtype=torch.float32)
    xr = x.clone().requires_grad_(True)
    loss_ref = ref(xr, phi_c, target)[0]
    (g_ref,) = torch.autograd.grad(loss_ref, xr)
    xp = x.clone()[None].requires_grad_(True)
    loss_port, _ = transfer_loss(params, xp, c_port, target_port, cfg, lspec)
    (g_port,) = torch.autograd.grad(loss_port, xp)
    torch.testing.assert_close(loss_ref, loss_port, rtol=1e-5, atol=0)
    # A relu gate within rounding of zero flips between the two sum orders
    # and moves its neighbourhood's cotangent (PERF.md: 1.1e-3 card vs CPU).
    assert rel_l2(g_port[0], g_ref) < 2e-3


def test_decoder_logits_and_nll_match_the_program():
    from audio_style_transfer_tpu_torch.models.wavenet_ae import (
        decode_logits,
        encoder_extracts,
        nll_loss,
    )
    from audio_style_transfer_tpu_torch.signal.mu_law import mu_law

    cfg = dict(CFG, **SMALL)
    params = make_params(cfg, 9, "cpu")
    mix = dict(small_cell("train_32x6144").traffic, distinct=1)
    wav = torch.as_tensor(traffic_gen.tone_batches(9, mix)[0])
    xq = nsynth.mu_law(wav)
    torch.testing.assert_close(xq, mu_law(wav))
    _, encoding = nsynth.encoder(params, xq, cfg, encoding=True)
    logits = nsynth.decoder_logits(params, xq, encoding, cfg)
    _, enc_port = encoder_extracts(_port_params(params), xq, model_config(cfg))
    logits_port = decode_logits(_port_params(params), xq, enc_port, model_config(cfg))
    torch.testing.assert_close(logits, logits_port, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(nsynth.nll_sum(logits, xq) / xq.numel(),
                               nll_loss(logits_port, xq), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("steps", [1, 3])
def test_adam_and_ema_steps_match_the_program(steps):
    from audio_style_transfer_tpu_torch.train.trainer import Trainer

    cell = small_cell("train_32x6144")
    work = cell.kind.Workload(cell, 21, "cpu")
    tr = Trainer(work._train_config(), model_config(cell.config, remat=True), device="cpu")
    params0 = make_params(cell.config, 21, "cpu")
    state = tr.init_state(_port_params(params0))
    batches = traffic_gen.tone_batches(21, cell.traffic)[:steps]
    losses = [float(tr.step(state, b)[1]) for b in batches]
    ref = ref_train.follow(params0, torch.as_tensor(batches), cell.config, steps=steps)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    norm = lambda d: {k: float(v.detach().norm()) for k, v in d.items()}  # noqa: E731
    p = ref_train.leaves(state["params"])
    assert worst_leaf_gap(norm(p), norm(ref["params"])) < 1e-5
    assert worst_leaf_gap(norm(ref_train.leaves(state["ema"])), norm(ref["ema"])) < 1e-5
