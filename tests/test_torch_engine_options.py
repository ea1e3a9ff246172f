"""Engine options of the port that had no run of their own: ``gatys`` (the
per-layer channel x channel gram) and ``warm_start`` (the L-BFGS memory
carried across epochs), against the JAX engine at the toy geometry of
tests/test_torch_slice.py (4 layers of width 16, T=4096, float32, CPU).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import TOY, jax_params_np, torch_params

from audio_style_transfer_tpu.models.wavenet_ae import WaveNetAEConfig as JCfg
from audio_style_transfer_tpu.signal.mu_law import mu_law_numpy
from audio_style_transfer_tpu.transfer import engine as jengine
from audio_style_transfer_tpu.transfer import losses as jlosses
from audio_style_transfer_tpu_torch.models.wavenet_ae import WaveNetAEConfig as TCfg
from audio_style_transfer_tpu_torch.transfer import engine as tengine
from audio_style_transfer_tpu_torch.transfer import lbfgs as tlbfgs
from audio_style_transfer_tpu_torch.transfer import losses as tlosses

T = 4096
KW = dict(stack=None, style_lyr_ids=(0, 1, 2), cont_lyr_ids=(3,), batch_size=T,
          write_artifacts=False)


def _pair(**over):
    pnp = jax_params_np(**TOY)
    spec = {**KW, **over}
    return (jengine.StyleTransfer(jengine.TransferSpec(fused_encoder=False, **spec),
                                  jax.tree.map(jnp.asarray, pnp), JCfg(**TOY)),
            tengine.StyleTransfer(tengine.TransferSpec(device="cpu", **spec),
                                  torch_params(pnp), TCfg(**TOY)))


def _audio(seed):
    """The targets' clip of tests/test_torch_slice.py: 0.2 * randn."""
    return (0.2 * np.random.RandomState(seed).randn(T)).astype(np.float32)


@pytest.mark.parametrize("gatys,rtol", [(True, 3e-3), (False, 1e-3)])
def test_engine_two_epochs_match_jax_with_gatys(gatys, rtol):
    """2 epochs (no early stop) through the engine: the targets, and the loss
    and its waveform gradient at a clip, at 1e-5; then equal evaluation counts
    and per-epoch metrics within rtol 1e-3 (the engine test's tolerance from
    the 1e-6 start) for the channel-wise gram. From that start an iteration
    can amplify summation-order differences a hundredfold (the two gradients
    there agree to 3e-7 of their largest entry, and at maxiter 2 the first
    epoch is equal to the last digit): with the Gatys gram the style term is
    5e-4 apart after the third iteration, 5e-5 after the fourth and 1.8e-3
    after the second epoch, with the total loss inside 1e-3 throughout; that
    run is held at rtol 3e-3."""
    jeng, teng = _pair(gatys=gatys, epochs=2, maxiter=4, early_stop_evals=0)
    phi_c, phi_s = jeng.get_embeds(_audio(11)), jeng.get_embeds(_audio(12), is_content=False)
    assert phi_s.shape == ((3, 16, 16) if gatys else (16, 3, 3))
    np.testing.assert_allclose(teng.get_embeds(_audio(12), is_content=False), phi_s,
                               rtol=1e-5, atol=1e-5)

    xq = mu_law_numpy(_audio(13)[None]).astype(np.float32)
    jf, jg = jax.value_and_grad(lambda x: jlosses.transfer_loss(
        jeng.params, x, jnp.asarray(phi_c), jnp.asarray(phi_s), jeng.cfg, jeng.loss_spec)[0])(
            jnp.asarray(xq))
    xt = torch.tensor(xq).requires_grad_(True)
    tf, _ = tlosses.transfer_loss(teng.params, xt, torch.tensor(phi_c), torch.tensor(phi_s),
                                  teng.cfg, teng.loss_spec)
    (tg,) = torch.autograd.grad(tf, xt)
    np.testing.assert_allclose(float(tf.detach()), float(jf), rtol=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5 * float(np.abs(jg).max()))

    jr, tr = jeng.optimize(phi_c, phi_s), teng.optimize(phi_c, phi_s)
    assert tr["epochs_done"] == jr["epochs_done"] == 2
    assert tr["evals"].tolist() == np.asarray(jr["evals"]).tolist()
    np.testing.assert_allclose(tr["metrics"], np.asarray(jr["metrics"]), rtol=rtol, atol=1e-6)
    np.testing.assert_allclose(tr["metrics"][:, 0], np.asarray(jr["metrics"])[:, 0], rtol=1e-3)
    assert tr["metrics"][1, 0] <= tr["metrics"][0, 0]


def test_warm_start_matches_cold_final_loss():
    """``warm_start`` carries the L-BFGS memory across epochs: the final loss
    stays within 1% of the cold-restart run (the parity budget of the JAX
    test of the same name) while spending no more evaluations (6 epochs at
    maxiter 8)."""
    _, cold_engine = _pair(epochs=6, maxiter=8)
    warm_engine = tengine.StyleTransfer(
        dataclasses.replace(cold_engine.spec, warm_start=True), cold_engine.params, TCfg(**TOY))
    phi_c = cold_engine.get_embeds(_audio(11))
    phi_s = cold_engine.get_embeds(_audio(12), is_content=False)
    cold = cold_engine.optimize(phi_c, phi_s, epochs=6)
    warm = warm_engine.optimize(phi_c, phi_s, epochs=6)
    f_cold = cold["metrics"][cold["epochs_done"] - 1, 0]
    f_warm = warm["metrics"][warm["epochs_done"] - 1, 0]
    assert abs(f_warm - f_cold) / abs(f_cold) < 0.01, (f_cold, f_warm)
    assert int(np.sum(warm["evals"])) <= int(np.sum(cold["evals"])), (warm["evals"],
                                                                      cold["evals"])


def test_warm_start_matches_jax_warm_start():
    """The warm run itself against JAX's: equal evaluation counts and metrics
    within rtol 1e-3 over 2 epochs of maxiter 5 (the second starts from the
    first's memory)."""
    jeng, teng = _pair(epochs=2, maxiter=5, early_stop_evals=0, warm_start=True)
    phi_c, phi_s = jeng.get_embeds(_audio(11)), jeng.get_embeds(_audio(12), is_content=False)
    jr, tr = jeng.optimize(phi_c, phi_s), teng.optimize(phi_c, phi_s)
    assert tr["evals"].tolist() == np.asarray(jr["evals"]).tolist()
    np.testing.assert_allclose(tr["metrics"], np.asarray(jr["metrics"]), rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("warm", [True, False])
def test_warm_start_resets_the_memory_after_a_failed_line_search(monkeypatch, warm):
    """An epoch that ends on a failed line search (status 3) hands over its x
    with a reset memory, so the next epoch cannot inherit the identical state
    and repeat the failure; any other status hands the memory on. Cold runs
    never pass one."""
    _, teng = _pair(epochs=4, maxiter=2, early_stop_evals=0, warm_start=warm)
    statuses = [2, 3, 2, 2]
    seen, real = [], tlbfgs.lbfgs_minimize

    def fake(vg, x, opts, history=None, return_history=False, has_aux=False):
        seen.append(history)
        res, hist = real(vg, x, opts, history=history, return_history=True, has_aux=has_aux)
        return res._replace(status=statuses[len(seen) - 1]), {"tag": len(seen), **hist}

    monkeypatch.setattr(tengine, "lbfgs_minimize", fake)
    phi_c = teng.get_embeds(_audio(11))
    phi_s = teng.get_embeds(_audio(12), is_content=False)
    res = teng.optimize(phi_c, phi_s, epochs=4)
    assert res["epochs_done"] == 4 and len(seen) == 4
    if warm:
        assert seen[0] is None and seen[1]["tag"] == 1  # status 2: handed on
        assert seen[2] is None                          # status 3: reset
        assert seen[3]["tag"] == 3
        assert isinstance(seen[1]["s_hist"], torch.Tensor)
    else:
        assert seen == [None] * 4
