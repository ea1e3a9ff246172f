"""The port's exact long-form transfer (``transfer/longform.py::transfer_exact``,
``--exact``, ``--scan_window``) vs the JAX package at a toy geometry:
WaveNetAEConfig(ae_num_layers=6, ae_width=16), engine windows of 4096, style
layers (0, 1, 2, 3), content layer 5, float32 on the CPU, 2 epochs of maxiter
4 from the 1e-6 start. The JAX engine runs with ``fused_encoder=False`` (its
XLA path). Losses are held at rtol 1e-3 with equal evaluation counts, as
tests/test_torch_slice.py holds the engine from that start.
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_helpers import jax_params_np, torch_params

from audio_style_transfer_tpu.models.wavenet_ae import WaveNetAEConfig as JCfg
from audio_style_transfer_tpu.transfer import engine as jengine
from audio_style_transfer_tpu.transfer import longform as jlong
from audio_style_transfer_tpu_torch.models.wavenet_ae import WaveNetAEConfig as TCfg
from audio_style_transfer_tpu_torch.transfer import engine as tengine
from audio_style_transfer_tpu_torch.transfer import longform as tlong

GEOM = dict(ae_num_layers=6, ae_width=16)
W = 4096
SPEC = dict(stack=None, style_lyr_ids=(0, 1, 2, 3), cont_lyr_ids=(5,), batch_size=W, epochs=2,
            maxiter=4, early_stop_evals=0, write_artifacts=False)


def _clip(length, seed, freq):
    rng = np.random.RandomState(seed)
    return (0.3 * np.sin(np.arange(length) * freq) + 0.05 * rng.randn(length)).astype(np.float32)


_ENGINES = {}


def _engines(**over):
    key = tuple(sorted(over.items()))
    if key not in _ENGINES:
        pnp = jax_params_np(**GEOM)
        spec = {**SPEC, **over}
        _ENGINES[key] = (
            jengine.StyleTransfer(jengine.TransferSpec(fused_encoder=False, **spec),
                                  jax.tree.map(jnp.asarray, pnp), JCfg(**GEOM)),
            tengine.StyleTransfer(tengine.TransferSpec(device="cpu", **spec),
                                  torch_params(pnp), TCfg(**GEOM)))
    return _ENGINES[key]


def _same_run(tr, jr, t_valid, t_total, epochs):
    assert tr.audio.shape == jr.audio.shape == (t_valid,)
    assert np.all(np.isfinite(tr.audio))
    pw, jw = tr.per_window, jr.per_window
    assert set(pw) == {"metrics", "evals", "epochs_done", "t_optimized", "x"}
    assert pw["epochs_done"] == jw["epochs_done"] == epochs
    assert pw["t_optimized"] == jw["t_optimized"] == t_total
    assert pw["x"].shape == np.asarray(jw["x"]).shape == (1, t_total)
    assert pw["evals"].tolist() == np.asarray(jw["evals"]).tolist()
    np.testing.assert_allclose(pw["metrics"], np.asarray(jw["metrics"]), rtol=1e-3)
    assert pw["metrics"].dtype == np.float32 and pw["evals"].dtype == np.int32


# name: (content samples, scan_window, t_valid, t_total, epochs, engine overrides).
# From the 1e-6 start the trajectory amplifies summation-order differences
# about a hundredfold per iteration (the reference's ill-conditioned start
# point, ROADMAP.md queue 3 item 3): clips of one or two windows hold rtol
# 1e-3 over 2 epochs; the 4-window clip that reaches the edge/middle split is
# held over its first epoch.
RUNS = {
    "single window": (W + 300, None, W, W, 2, {}),
    "single window, gamma": (W + 300, None, W, W, 2, {"gamma": 1e-3}),
    "scan keeps the tail": (W + 1000, 2048, 4608, 6144, 2, {}),
    "scan, gamma": (W, 2048, W, W, 2, {"gamma": 1e-3}),
    "scan, edge/middle split": (2 * W + 100, 2048, 2 * W, 2 * W, 1, {}),
    "scan window beyond the clip": (W + 300, 4 * W, W, W, 2, {}),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_transfer_exact_matches_jax(name):
    length, scan_window, t_valid, t_total, epochs, over = RUNS[name]
    jeng, teng = _engines(**over)
    content, style = _clip(length, 0, 0.05), _clip(2 * W, 1, 0.11)
    jr = jlong.transfer_exact(jeng, content, style, mesh=None, epochs=epochs,
                              scan_window=scan_window)
    tr = tlong.transfer_exact(teng, content, style, mesh=None, epochs=epochs,
                              scan_window=scan_window)
    _same_run(tr, jr, t_valid, t_total, epochs)
    assert tr.per_window["metrics"][-1] <= tr.per_window["metrics"][0]


def test_transfer_exact_scan_equals_single_window():
    """Both flavours optimize the same objective: on a clip that tiles, the
    same evaluation counts and losses within the tolerance above."""
    _, teng = _engines()
    content, style = _clip(W, 0, 0.05), _clip(2 * W, 1, 0.11)
    one = tlong.transfer_exact(teng, content, style, epochs=2)
    scan = tlong.transfer_exact(teng, content, style, epochs=2, scan_window=2048)
    assert one.per_window["evals"].tolist() == scan.per_window["evals"].tolist()
    np.testing.assert_allclose(scan.per_window["metrics"], one.per_window["metrics"], rtol=1e-3)


@pytest.mark.parametrize("length,scan_window", [(W + 300, None), (2 * W + 100, 2048)],
                         ids=["single window", "scan, edge/middle split"])
def test_transfer_exact_per_layer_flavour_equals_the_chained_flavour(length, scan_window):
    """The per-layer trunk (fused_encoder=True, chain_encoder=False: K7f/K7b's
    plain versions) under ``transfer_exact``: as one unmasked window, and as
    the scan whose edge windows run the windowed blocks. The same blocks in
    the same float32 arithmetic as the chained trunk, so the same evaluation
    counts and losses to float32 summation order (rtol 1e-5)."""
    pnp = jax_params_np(**GEOM)
    runs = {}
    for flavour in ({}, {"fused_encoder": True, "chain_encoder": False}):
        engine = tengine.StyleTransfer(tengine.TransferSpec(device="cpu", **SPEC, **flavour),
                                       torch_params(pnp), TCfg(**GEOM))
        runs[bool(flavour)] = tlong.transfer_exact(
            engine, _clip(length, 0, 0.05), _clip(2 * W, 1, 0.11), epochs=1,
            scan_window=scan_window).per_window
    assert runs[True]["evals"].tolist() == runs[False]["evals"].tolist()
    np.testing.assert_allclose(runs[True]["metrics"], runs[False]["metrics"], rtol=1e-5)


def test_transfer_exact_with_the_ot_target_matches_jax(monkeypatch, capsys):
    """The OT target composes with the exact objective (from the NMF factors
    the JAX package draws, as tests/test_torch_longform.py starts them)."""
    from test_torch_longform import _jax_nmf_init

    from audio_style_transfer_tpu_torch.analysis import nmf as tnmf

    monkeypatch.setattr(
        tlong, "nmf", lambda x, k, generator=None: tnmf.nmf(x, k, init=_jax_nmf_init(x, k)))
    jeng, teng = _engines()
    content, style = _clip(W, 0, 0.05), _clip(2 * W, 1, 0.11)
    kw = dict(mesh=None, epochs=1, ot_components=3, ot_blend=0.5)
    jr = jlong.transfer_exact(jeng, content, style, **kw)
    tr = tlong.transfer_exact(teng, content, style, **kw)
    assert "OT transform: nmf rec err" in capsys.readouterr().out
    _same_run(tr, jr, W, W, 1)
    plain = tlong.transfer_exact(teng, content, style, epochs=1)
    assert np.any(tr.per_window["metrics"] != plain.per_window["metrics"])


def test_transfer_exact_stops_early_and_refuses_what_it_cannot_run():
    _, teng = _engines()
    early = tengine.StyleTransfer(
        tengine.TransferSpec(device="cpu", **{**SPEC, "early_stop_evals": 50}),
        teng.params, TCfg(**GEOM))
    content, style = _clip(W, 0, 0.05), _clip(W, 1, 0.11)
    res = tlong.transfer_exact(early, content, style, epochs=3)
    assert res.per_window["epochs_done"] == 1 and res.per_window["evals"].shape == (1,)
    # A mesh on another device than the engine's, and a clip shorter than the
    # mesh's quantum (4 ranks x 512), are refused before any collective.
    with pytest.raises(ValueError, match="a cuda mesh for an engine on cpu"):
        tlong.transfer_exact(teng, content, style, mesh=SimpleNamespace(device_type="cuda"))
    four = SimpleNamespace(device_type="cpu", mesh_dim_names=("time",), size=lambda dim: 4)
    with pytest.raises(ValueError, match="shorter than one 2048-sample quantum"):
        tlong.transfer_exact(teng, content[:2000], style, mesh=four)
    with pytest.raises(ValueError, match="shorter than one"):
        tlong.transfer_exact(teng, content[:3000], style)
    with pytest.raises(ValueError, match="shorter than one"):
        tlong.transfer_exact(teng, content[:300], style, scan_window=256)


@pytest.mark.parametrize("extra,t_valid", [((), 4096), (("--scan_window", "4096"), 5120)])
def test_exact_cli_on_cpu(tmp_path, extra, t_valid):
    """``--exact`` and ``--exact --scan_window`` at full width (30 layers of
    128, random weights) on a 0.35 s clip through the CLI on the CPU: the
    output keeps the clip to its quantum (4096 single-window, 512 in the
    scan, which pads to two windows), ``longform.wav`` lands in the
    ``exact_True`` run directory, and no JAX is imported."""
    from audio_style_transfer_tpu.utils.audio_io import write_wav

    sr = 16000
    tt = np.arange(int(0.35 * sr)) / sr
    src = tmp_path / "src"
    src.mkdir()
    write_wav(str(src / "tone.wav"), (0.5 * np.sin(2 * np.pi * 220 * tt)).astype(np.float32), sr)
    write_wav(str(src / "square.wav"),
              (0.4 * np.sign(np.sin(2 * np.pi * 330 * tt))).astype(np.float32), sr)
    code = (
        "import sys, torch; torch.set_num_threads(2);"
        "from audio_style_transfer_tpu_torch.cli.transfer import main;"
        "out = main(sys.argv[1:]);"
        "assert not any(m == 'jax' or m.startswith('audio_style_transfer_tpu.') "
        "or m == 'audio_style_transfer_tpu' for m in sys.modules);"
        "print('samples', out.shape[0])"
    )
    args = ["tone", "square", "--dir", str(src), "--outdir", str(tmp_path / "out"),
            "--logdir", str(tmp_path / "log"), "--device", "cpu", "--random_init",
            "--batch_size", "4096", "--epochs", "1", "--maxiter", "1", "--stack", "0",
            "--gamma", "1e-3", "--exact", *extra]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code, *args], cwd=tmp_path,
                       env=dict(os.environ, PYTHONPATH=repo), capture_output=True,
                       text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-2000:]
    assert f"optimized {t_valid / sr:.1f}s of audio" in r.stdout, r.stdout
    assert f"samples {t_valid}" in r.stdout, r.stdout
    wavs = list((tmp_path / "out").rglob("longform.wav"))
    assert len(wavs) == 1 and "exact_True" in wavs[0].parent.name


# One loss, three paths: the clip path's ``transfer_loss``, the exact
# single window and the exact window scan, on a 30-layer trunk of width 16
# (its receptive-field radius rounds up to 4096, so the scan's two windows of
# 2048 are both edge windows).
LOSS_GEOM = dict(ae_num_layers=30, ae_width=16)
LOSS_SPECS = {
    "stack 0": dict(style_layer_ids=tuple(range(10)), cont_lyr_ids=(29,)),
    "full stack": dict(style_layer_ids=tuple(range(30)), cont_lyr_ids=(25,)),
    "gatys": dict(style_layer_ids=tuple(range(30)), cont_lyr_ids=(25,), gatys=True),
}


@pytest.mark.parametrize("gamma", [0.0, 1e-3])
@pytest.mark.parametrize("name", sorted(LOSS_SPECS))
def test_the_clip_loss_and_the_exact_losses_are_one_function(name, gamma):
    """In float32 on one clip and its targets: the single-window exact loss
    is the clip path's ``transfer_loss`` bit for bit (the same taps, grams and
    sums), and the two-window scan's value equals it within the tolerance of
    ``test_transfer_exact_scan_equals_single_window`` (float32 sums over the
    windows in another order)."""
    import torch

    from audio_style_transfer_tpu_torch.models.wavenet_ae import init_params
    from audio_style_transfer_tpu_torch.parallel import halo
    from audio_style_transfer_tpu_torch.signal.mu_law import mu_law
    from audio_style_transfer_tpu_torch.transfer.losses import (
        LossSpec,
        transfer_embeds,
        transfer_loss,
    )

    cfg = TCfg(**LOSS_GEOM)
    params = init_params(0, cfg)
    spec = LossSpec(gamma=gamma, **LOSS_SPECS[name])
    x = mu_law(torch.from_numpy(_clip(W, 0, 0.05)))[None]
    phi_c, _ = transfer_embeds(params, mu_law(torch.from_numpy(_clip(W, 2, 0.07)))[None], cfg,
                               spec)
    _, phi_s = transfer_embeds(params, mu_law(torch.from_numpy(_clip(W, 1, 0.11)))[None], cfg,
                               spec)
    clip, parts = transfer_loss(params, x, phi_c, phi_s, cfg, spec)
    assert (float(parts["regularizer"]) > 0.0) == (gamma != 0.0)
    single = halo._single_window_exact_loss_fn(cfg, spec, W)(params, x, phi_c, phi_s)
    assert torch.equal(single, clip)
    scan, grad = halo.make_scan_exact_value_and_grad_fn(cfg, spec, W, 2048)(
        params, x, phi_c, phi_s)
    assert grad.shape == (1, W)
    np.testing.assert_allclose(float(scan), float(single), rtol=1e-3)
