"""The port's stack-0 transfer slice vs the JAX package at toy geometry.

WaveNetAEConfig(ae_num_layers=4, ae_width=16), style layers (0, 1, 2),
content layer 3, batch 4096, float32 on the CPU: the loss, its waveform
gradient, the L-BFGS zoom search and the engine's epoch loop, each against
its JAX counterpart on the same weights and inputs. The JAX engine runs with
``fused_encoder=False`` (its XLA path, which tests/test_pallas_chain.py pins
to the fused kernels).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import TOY, jax_params_np, n, t, torch_params

from audio_style_transfer_tpu.models.wavenet_ae import WaveNetAEConfig as JCfg
from audio_style_transfer_tpu.signal.mu_law import mu_law_numpy
from audio_style_transfer_tpu.transfer import engine as jengine
from audio_style_transfer_tpu.transfer import lbfgs as jlbfgs
from audio_style_transfer_tpu.transfer import losses as jlosses
from audio_style_transfer_tpu_torch.models.wavenet_ae import WaveNetAEConfig as TCfg
from audio_style_transfer_tpu_torch.transfer import engine as tengine
from audio_style_transfer_tpu_torch.transfer import lbfgs as tlbfgs
from audio_style_transfer_tpu_torch.transfer import losses as tlosses

T = 4096
STYLE, CONT = (0, 1, 2), (3,)
# f32 on the CPU: the same float32 arithmetic summed in different orders.
RTOL = ATOL = 1e-5
ZOOM = dict(line_search="zoom", restart_on_ls_fail=False)


@pytest.fixture(scope="module")
def setup():
    pnp = jax_params_np(**TOY)
    jp = jax.tree.map(jnp.asarray, pnp)
    tp = torch_params(pnp)
    spec_j = jlosses.LossSpec(cont_lyr_ids=CONT, style_layer_ids=STYLE)
    spec_t = tlosses.LossSpec(cont_lyr_ids=CONT, style_layer_ids=STYLE)
    rng = np.random.RandomState(0)
    audio = (0.3 * np.sin(np.arange(T) * 0.05) + 0.05 * rng.randn(T)).astype(np.float32)
    xq = mu_law_numpy(audio)[None].astype(np.float32)
    # Targets: the embeds of another clip, so the loss is not zero.
    other = mu_law_numpy(0.2 * rng.randn(1, T)).astype(np.float32)
    phi_c, phi_s = jlosses.transfer_embeds(jp, jnp.asarray(other), JCfg(**TOY), spec_j)
    return dict(jp=jp, tp=tp, spec_j=spec_j, spec_t=spec_t, xq=xq,
                phi_c=np.asarray(phi_c), phi_s=np.asarray(phi_s))


def _jax_vg(s):
    def loss(x):
        return jlosses.transfer_loss(s["jp"], x[None], jnp.asarray(s["phi_c"]),
                                     jnp.asarray(s["phi_s"]), JCfg(**TOY), s["spec_j"])
    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def _torch_vg(s):
    phi_c, phi_s = t(s["phi_c"]), t(s["phi_s"])

    def vg(x):
        xv = x.detach().requires_grad_(True)
        loss, parts = tlosses.transfer_loss(s["tp"], xv[None], phi_c, phi_s,
                                            TCfg(**TOY), s["spec_t"])
        (g,) = torch.autograd.grad(loss, xv)
        return (loss.detach(), parts), g
    return vg


def test_embeds_loss_and_waveform_gradient_match_jax(setup):
    s = setup
    cj, sj = jlosses.transfer_embeds(s["jp"], jnp.asarray(s["xq"]), JCfg(**TOY), s["spec_j"])
    ct, st = tlosses.transfer_embeds(s["tp"], t(s["xq"]), TCfg(**TOY), s["spec_t"])
    np.testing.assert_allclose(n(ct), n(cj), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(n(st), n(sj), rtol=RTOL, atol=ATOL)

    (fj, pj), gj = _jax_vg(s)(jnp.asarray(s["xq"][0]))
    (ft, pt), gt = _torch_vg(s)(t(s["xq"][0]))
    for k in ("loss", "content_loss", "style_loss", "regularizer"):
        np.testing.assert_allclose(n(pt[k]), n(pj[k]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(n(gt), n(gj), rtol=RTOL, atol=ATOL * float(np.abs(gj).max()))


def test_gamma_regularizer_not_ported(setup):
    s = setup
    spec = dataclasses.replace(s["spec_t"], gamma=1.0)
    with pytest.raises(NotImplementedError, match="stft_l1"):
        tlosses.transfer_loss(s["tp"], t(s["xq"]), t(s["phi_c"]), t(s["phi_s"]),
                              TCfg(**TOY), spec)


def test_lbfgs_zoom_on_quadratic_matches_jax():
    rng = np.random.RandomState(0)
    m = rng.randn(24, 24).astype(np.float32)
    a = (m @ m.T / 24 + np.eye(24, dtype=np.float32)).astype(np.float32)
    b = rng.randn(24).astype(np.float32)
    x0 = np.zeros(24, np.float32)
    # maxiter 6 stops before the float32 plateau, where the last iterations
    # only chase rounding noise and any two summation orders part ways.
    jopts = jlbfgs.LBFGSOptions(maxiter=6, **ZOOM)
    topts = tlbfgs.LBFGSOptions(maxiter=6, **ZOOM)
    aj, bj = jnp.asarray(a), jnp.asarray(b)
    jres = jlbfgs.lbfgs_minimize(
        jax.value_and_grad(lambda x: 0.5 * x @ aj @ x - bj @ x), jnp.asarray(x0), jopts)
    at, bt = t(a), t(b)

    def vg(x):
        return 0.5 * x @ at @ x - bt @ x, at @ x - bt
    tres = tlbfgs.lbfgs_minimize(vg, t(x0), topts)
    assert tres.n_evals == int(jres.n_evals)
    assert tres.status == int(jres.status)
    np.testing.assert_allclose(float(tres.f), float(jres.f), rtol=1e-5)
    np.testing.assert_allclose(n(tres.x), n(jres.x), rtol=1e-4, atol=1e-5)


def test_lbfgs_zoom_on_toy_transfer_loss_matches_jax(setup):
    """Started from the content clip itself. (From the engine's 1e-6 start
    the first step is scaled by 1/||g||_1 and the trajectory amplifies
    float32 summation-order differences about a hundredfold per iteration:
    the engine test below holds that case at rtol 1e-3.)"""
    s = setup
    x0 = s["xq"][0].copy()
    jres = jlbfgs.lbfgs_minimize(_jax_vg(s), jnp.asarray(x0),
                                 jlbfgs.LBFGSOptions(maxiter=5, **ZOOM), has_aux=True)
    tres = tlbfgs.lbfgs_minimize(_torch_vg(s), t(x0),
                                 tlbfgs.LBFGSOptions(maxiter=5, **ZOOM), has_aux=True)
    assert tres.n_evals == int(jres.n_evals)
    np.testing.assert_allclose(float(tres.f), float(jres.f), rtol=1e-5)
    np.testing.assert_allclose(n(tres.aux["loss"]), n(jres.aux["loss"]), rtol=1e-5)


def test_mt_line_search_not_ported():
    with pytest.raises(NotImplementedError, match="zoom"):
        tlbfgs.lbfgs_minimize(lambda x: (x.sum(), torch.ones_like(x)), torch.zeros(3),
                              tlbfgs.LBFGSOptions(line_search="mt"))


def test_engine_two_epochs_match_jax(setup):
    """2 epochs at maxiter 5 (no early stop): per-epoch metrics within rtol
    1e-3 and identical evaluation counts."""
    s = setup
    kw = dict(stack=None, style_lyr_ids=STYLE, cont_lyr_ids=CONT, batch_size=T,
              epochs=2, maxiter=5, early_stop_evals=0, write_artifacts=False)
    jeng = jengine.StyleTransfer(jengine.TransferSpec(fused_encoder=False, **kw),
                                 s["jp"], JCfg(**TOY))
    teng = tengine.StyleTransfer(tengine.TransferSpec(device="cpu", **kw),
                                 s["tp"], TCfg(**TOY))
    jr = jeng.optimize(s["phi_c"], s["phi_s"])
    tr = teng.optimize(s["phi_c"], s["phi_s"])
    assert tr["epochs_done"] == jr["epochs_done"] == 2
    assert tr["evals"].tolist() == np.asarray(jr["evals"]).tolist()
    np.testing.assert_allclose(tr["metrics"], np.asarray(jr["metrics"]), rtol=1e-3, atol=1e-6)
    assert tr["metrics"][1, 0] <= tr["metrics"][0, 0]


def test_cli_smoke_on_cpu(tmp_path):
    """The port's CLI end to end on the CPU at full width (30 layers of 128,
    random weights), one short epoch."""
    from audio_style_transfer_tpu.utils.audio_io import write_wav

    sr = 16000
    tt = np.arange(int(0.6 * sr)) / sr
    src = tmp_path / "src"
    src.mkdir()
    write_wav(str(src / "tone.wav"), (0.5 * np.sin(2 * np.pi * 220 * tt)).astype(np.float32), sr)
    write_wav(str(src / "square.wav"),
              (0.4 * np.sign(np.sin(2 * np.pi * 330 * tt))).astype(np.float32), sr)
    code = (
        "import sys, torch; torch.set_num_threads(2);"
        "from audio_style_transfer_tpu_torch.cli.transfer import main;"
        "out = main(sys.argv[1:]);"
        "assert 'jax' not in sys.modules;"
        "print('samples', out.shape[0])"
    )
    args = ["tone", "square", "--dir", str(src), "--outdir", str(tmp_path / "out"),
            "--logdir", str(tmp_path / "log"), "--device", "cpu", "--random_init",
            "--no_artifacts", "--stack", "0", "--batch_size", "4096", "--epochs", "1",
            "--maxiter", "3", "--start", "0.1"]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    r = subprocess.run([sys.executable, "-c", code, *args], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "optimized 1 epochs" in r.stdout, r.stdout
    assert "samples 4096" in r.stdout, r.stdout
