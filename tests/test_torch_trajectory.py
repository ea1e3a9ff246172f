"""The port's north-star trajectory against the JAX CPU goldens (slow).

Full geometry (30 layers of width 128, T=16384, stack-0 channel grams),
float32 on the CPU, 3 epochs of maxiter 10 with no early stop, the weights
of the JAX ``init_params(PRNGKey(0))`` carried across, and the target built
as tests/test_trajectory_golden.py builds it. The goldens are
tests/test_trajectory_golden.py:34-35.
"""

import numpy as np
import pytest
import torch
from torch_helpers import jax_params_np, torch_params

from test_trajectory_golden import EPOCHS, GOLDEN_EVALS, GOLDEN_LOSSES, MAXITER

# Epochs 1-2 agree within 4e-4 in every run below. Epoch 3 takes a large
# descent whose end point is set by float32 summation order, on either side.
# Epoch-3 losses of the north-star program on the CPU in float32, with the
# weights as drawn and moved one float32 ulp (np.nextafter):
#   JAX:  as drawn 1007.19 (the golden); every weight up 1132.74 (+12.5%,
#         evals 26/17/28); every w down 1156.35 (+14.8%).
#   port: as drawn 1235.32 (+22.7% of the golden, evals 26/17/26); every
#         weight up 1238.51; every w up 1186.41; every w down 1217.51.
# One ulp moves JAX's own end point by more than half the port's distance
# from it, so the gap is trajectory sensitivity, not a port fault. The
# tolerance covers the widest of the seven runs (+23.0%) with a margin.
RTOL_EPOCHS_1_2 = 5e-4
RTOL_EPOCH_3 = 0.25
# The least that one ulp of weight moves JAX's epoch 3 (measured: 12.5%).
MIN_SPREAD_EPOCH_3 = 0.05


def _clips():
    from bench import synth_audio

    return synth_audio(2.0, kind="content"), synth_audio(2.0, kind="style")


def _run():
    from audio_style_transfer_tpu_torch.transfer.engine import StyleTransfer, TransferSpec
    from audio_style_transfer_tpu_torch.transfer.grams import l2_normalize

    torch.set_num_threads(4)
    spec = TransferSpec(stack=0, batch_size=16384, epochs=EPOCHS, maxiter=MAXITER,
                        early_stop_evals=0, compute_dtype="float32",
                        write_artifacts=False, device="cpu")
    engine = StyleTransfer(spec, torch_params(jax_params_np(0)))
    content, style = _clips()
    phi_c = engine.get_embeds(content[:16384])
    phi_t = engine.get_style_phi(style)
    phi_s = engine.get_style_phi(content)
    phi = engine.get_embeds(content[:16384], is_content=False)
    phi = l2_normalize(torch.as_tensor(phi + phi_t - phi_s), axes=(1, 2)).numpy()
    return engine.optimize(phi_c, phi, epochs=EPOCHS)


def _run_jax_one_ulp_up():
    """tests/test_trajectory_golden.py::_run with every weight moved one
    float32 ulp toward +inf."""
    import jax.numpy as jnp

    from audio_style_transfer_tpu.transfer import StyleTransfer, TransferSpec
    from audio_style_transfer_tpu.transfer.grams import l2_normalize

    params = {layer: {k: jnp.asarray(np.nextafter(v, np.float32(np.inf)))
                      for k, v in e.items()}
              for layer, e in jax_params_np(0).items()}
    spec = TransferSpec(stack=0, batch_size=16384, epochs=EPOCHS, maxiter=MAXITER,
                        early_stop_evals=0, compute_dtype="float32",
                        fused_encoder=False, write_artifacts=False)
    engine = StyleTransfer(spec, params)
    content, style = _clips()
    phi_c = engine.get_embeds(content[:16384])
    phi_t = engine.get_style_phi(style)
    phi_s = engine.get_style_phi(content)
    phi = engine.get_embeds(content[:16384], is_content=False)
    phi = np.asarray(l2_normalize(jnp.asarray(phi + phi_t - phi_s), axes=(1, 2)))
    return engine.optimize(phi_c, phi, epochs=EPOCHS)


@pytest.mark.slow
def test_port_north_star_trajectory_matches_jax_goldens():
    res = _run()
    losses = np.asarray(res["metrics"][:, 0], np.float64)
    print("losses", losses.tolist(), "evals", res["evals"].tolist())
    np.testing.assert_allclose(losses[:2], GOLDEN_LOSSES[:2], rtol=RTOL_EPOCHS_1_2)
    np.testing.assert_allclose(losses[2], GOLDEN_LOSSES[2], rtol=RTOL_EPOCH_3)
    assert tuple(int(e) for e in res["evals"]) == GOLDEN_EVALS, res["evals"]


@pytest.mark.slow
def test_jax_epoch_3_moves_under_one_ulp_of_weight():
    """The JAX program itself, one ulp away from its golden weights: epochs
    1-2 stay put and epoch 3 moves by a share comparable to the port's gap,
    inside the tolerance the port is held to."""
    res = _run_jax_one_ulp_up()
    losses = np.asarray(res["metrics"][:, 0], np.float64)
    print("losses", losses.tolist(), "evals", np.asarray(res["evals"]).tolist())
    np.testing.assert_allclose(losses[:2], GOLDEN_LOSSES[:2], rtol=RTOL_EPOCHS_1_2)
    spread = abs(losses[2] - GOLDEN_LOSSES[2]) / GOLDEN_LOSSES[2]
    assert MIN_SPREAD_EPOCH_3 <= spread <= RTOL_EPOCH_3, spread
