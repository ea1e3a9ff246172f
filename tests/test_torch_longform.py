"""The port's chunked long-form transfer (transfer/longform.py,
``engine.optimize_batch``, ``--longform``) vs the JAX package at a toy
geometry: WaveNetAEConfig(ae_num_layers=6, ae_width=16), windows of 4096,
style layers (0, 1, 2, 3), content layer 5, float32 on the CPU. The JAX
engine runs with ``fused_encoder=False`` (its XLA path).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import jax_params_np, n, t, torch_params

from audio_style_transfer_tpu.models.wavenet_ae import WaveNetAEConfig as JCfg
from audio_style_transfer_tpu.signal.mu_law import mu_law_numpy
from audio_style_transfer_tpu.transfer import engine as jengine
from audio_style_transfer_tpu.transfer import longform as jlong
from audio_style_transfer_tpu_torch.analysis import nmf as tnmf
from audio_style_transfer_tpu_torch.models.wavenet_ae import WaveNetAEConfig as TCfg
from audio_style_transfer_tpu_torch.transfer import engine as tengine
from audio_style_transfer_tpu_torch.transfer import longform as tlong

GEOM = dict(ae_num_layers=6, ae_width=16)
W = 4096
STYLE, CONT = (0, 1, 2, 3), (5,)
SPEC = dict(stack=None, style_lyr_ids=STYLE, cont_lyr_ids=CONT, batch_size=W, epochs=2,
            maxiter=4, early_stop_evals=0, write_artifacts=False)


def _clip(length, seed, freq):
    rng = np.random.RandomState(seed)
    return (0.3 * np.sin(np.arange(length) * freq) + 0.05 * rng.randn(length)).astype(np.float32)


@pytest.fixture(scope="module")
def engines():
    pnp = jax_params_np(**GEOM)
    jeng = jengine.StyleTransfer(jengine.TransferSpec(fused_encoder=False, **SPEC),
                                 jax.tree.map(jnp.asarray, pnp), JCfg(**GEOM))
    teng = tengine.StyleTransfer(tengine.TransferSpec(device="cpu", **SPEC),
                                 torch_params(pnp), TCfg(**GEOM))
    return jeng, teng


@pytest.fixture(scope="module")
def clips():
    return _clip(3 * W + 100, 0, 0.05), _clip(2 * W, 1, 0.11)


def test_chunk_audio_drops_the_partial_window():
    x = np.arange(10, dtype=np.float32)
    np.testing.assert_array_equal(tlong.chunk_audio(x, 4), jlong.chunk_audio(x, 4))
    assert tlong.chunk_audio(x, 4).shape == (2, 4)
    assert tlong.chunk_audio(x[:3], 4).shape == (0, 4)


@pytest.mark.parametrize("crossfade", [0, 10, 64])
def test_stitch_equals_jax(crossfade):
    rng = np.random.RandomState(0)
    wins = [rng.randn(200).astype(np.float32) for _ in range(3)]
    got = tlong._stitch(wins, crossfade)
    np.testing.assert_array_equal(got, jlong._stitch(wins, crossfade))
    assert got.shape == (600 - 2 * crossfade,)
    assert tlong._stitch([], 10).shape == (0,)
    np.testing.assert_array_equal(tlong._stitch(wins[:1], 10), wins[0])


def test_window_targets_match_jax(engines, clips):
    """Per-window content embeds and translated style grams at 1e-5 (the
    slice tests' tolerance), left as tensors on the engine's device."""
    jeng, teng = engines
    content, style = clips
    wins = mu_law_numpy(tlong.chunk_audio(content, W)).astype(np.float32)
    pt, ps = jeng.get_style_phi(style), jeng.get_style_phi(content)
    np.testing.assert_allclose(teng.get_style_phi(style), pt, rtol=1e-5, atol=1e-5)
    jc, jg = jlong._window_targets(jeng.params, jnp.asarray(wins), jnp.asarray(pt),
                                   jnp.asarray(ps), cfg=jeng.cfg, lspec=jeng.loss_spec)
    tc, tg = tlong._window_targets(teng.params, t(wins), t(pt), t(ps), teng.cfg, teng.loss_spec)
    assert isinstance(tc, torch.Tensor) and tc.shape == (3, W, 16)
    assert tg.shape == (3, 16, 4, 4)
    np.testing.assert_allclose(n(tc), n(jc), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(tg), n(jg), rtol=1e-5, atol=1e-5)


def _jax_nmf_init(x, k):
    """The initial factors JAX's ``nmf(seed=0)`` draws for a [L, n, f] stack
    under vmap: the same normal draws for every layer, scaled per layer."""
    key_w, key_h = jax.random.split(jax.random.PRNGKey(0))
    nrm_w = np.abs(np.asarray(jax.random.normal(key_w, (x.shape[-2], k))))
    nrm_h = np.abs(np.asarray(jax.random.normal(key_h, (k, x.shape[-1]))))
    avg = np.sqrt(n(x).mean(axis=(-2, -1), keepdims=True) / k)
    return avg * nrm_w, avg * nrm_h


@pytest.fixture
def jax_nmf_factors(monkeypatch):
    """Start the port's NMFs from the factors the JAX package draws."""
    monkeypatch.setattr(
        tlong, "nmf",
        lambda x, k, generator=None: tnmf.nmf(x, k, init=_jax_nmf_init(x, k)))


def test_ot_translated_gram_matches_jax(engines, clips, jax_nmf_factors, capsys):
    """From the same NMF factors: the three grams within 1e-4 of their largest
    entry (NMF and ADMM drift, tests/test_torch_nmf_ot.py), and the transport
    moves the content gram toward the style gram on both sides."""
    jeng, teng = engines
    content, style = clips
    want = jlong.ot_translated_gram(jeng, style, content, 3)
    got = tlong.ot_translated_gram(teng, style, content, 3)
    assert "OT transform: nmf rec err" in capsys.readouterr().out
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.shape == w.shape == (16, 4, 4)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * float(np.abs(w).max()))
    g_ot, g_c, g_s = got
    assert np.linalg.norm(g_ot - g_c) > 0
    # blend 0 leaves the reference target, renormalized.
    phi_t = teng.get_style_phi(style)
    blended = tlong._ot_transform_gram(teng, style, content, phi_t, 3, blend=0.0)
    norm = np.sqrt(np.sum(phi_t**2, axis=(1, 2), keepdims=True))
    np.testing.assert_allclose(blended, phi_t / norm, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("with_x0", [False, True])
def test_optimize_batch_equals_single_clip_runs(engines, clips, with_x0):
    """K clips through ``optimize_batch`` are K calls of ``optimize``, bit for
    bit, stacked as JAX stacks them (rows past ``epochs_done`` stay zero)."""
    _, teng = engines
    content, style = clips
    wins = mu_law_numpy(tlong.chunk_audio(content, W)[:2]).astype(np.float32)
    pt, ps = t(teng.get_style_phi(style)), t(teng.get_style_phi(content))
    phi_c, phi_s = tlong._window_targets(teng.params, t(wins), pt, ps, teng.cfg, teng.loss_spec)
    x0 = wins[:, None, :] if with_x0 else None
    res = teng.optimize_batch(phi_c, phi_s, epochs=2, x0=x0)
    assert res["snapshots"].shape == (2, 2, W) and res["metrics"].shape == (2, 2, 4)
    assert res["evals"].shape == (2, 2) and res["x"].shape == (2, 1, W)
    assert res["epochs_done"].tolist() == [2, 2]
    for i in range(2):
        one = teng.optimize(n(phi_c[i]), n(phi_s[i]), epochs=2,
                            x0=None if x0 is None else x0[i])
        np.testing.assert_array_equal(res["snapshots"][i], one["snapshots"])
        np.testing.assert_array_equal(res["metrics"][i], one["metrics"])
        np.testing.assert_array_equal(res["evals"][i], one["evals"])
        np.testing.assert_array_equal(res["x"][i], one["x"])


def test_optimize_batch_stops_each_clip_on_its_own(engines, clips):
    """With the reference's early stop every clip ends after its first short
    epoch, and the rows of the epochs it did not run stay zero."""
    _, teng = engines
    content, style = clips
    early = tengine.StyleTransfer(
        tengine.TransferSpec(device="cpu", **{**SPEC, "early_stop_evals": 50}),
        teng.params, TCfg(**GEOM))
    wins = mu_law_numpy(tlong.chunk_audio(content, W)[:2]).astype(np.float32)
    phi_c, phi_s = tlong._window_targets(
        early.params, t(wins), t(early.get_style_phi(style)),
        t(early.get_style_phi(content)), early.cfg, early.loss_spec)
    res = early.optimize_batch(phi_c, phi_s, epochs=3)
    assert res["epochs_done"].tolist() == [1, 1]
    assert res["snapshots"].shape == (2, 3, W)
    assert not res["snapshots"][:, 1:].any() and not res["evals"][:, 1:].any()
    np.testing.assert_array_equal(res["x"][:, 0], res["snapshots"][:, 0])


def test_transfer_longform_matches_jax(engines, clips):
    """3 windows, 2 epochs of maxiter 4 from the engine's 1e-6 start: equal
    evaluation counts and per-window metrics within rtol 1e-3, the engine
    test's tolerance (tests/test_torch_slice.py); the stitched audio has the
    length the crossfade leaves."""
    jeng, teng = engines
    content, style = clips
    jr = jlong.transfer_longform(jeng, content, style, epochs=2, crossfade=64)
    tr = tlong.transfer_longform(teng, content, style, epochs=2, crossfade=64)
    assert tr.audio.shape == jr.audio.shape == (3 * W - 2 * 64,)
    assert np.all(np.isfinite(tr.audio))
    assert tr.per_window["evals"].tolist() == np.asarray(jr.per_window["evals"]).tolist()
    assert tr.per_window["epochs_done"].tolist() == [2, 2, 2]
    want = np.asarray(jr.per_window["metrics"])
    np.testing.assert_allclose(tr.per_window["metrics"], want, rtol=1e-3,
                               atol=1e-6 * float(want[..., 0].max()))
    assert tr.per_window["x"].shape == (3, 1, W)


def test_transfer_longform_with_the_ot_target_matches_jax(engines, clips, jax_nmf_factors):
    """The OT target composes with the chunked transfer: from the same NMF
    factors, 2 windows and one epoch agree with JAX as above."""
    jeng, teng = engines
    content, style = clips
    kw = dict(epochs=1, ot_components=3, ot_blend=0.5, crossfade=0)
    jr = jlong.transfer_longform(jeng, content[: 2 * W], style, **kw)
    tr = tlong.transfer_longform(teng, content[: 2 * W], style, **kw)
    assert tr.audio.shape == jr.audio.shape == (2 * W,)
    assert tr.per_window["evals"].tolist() == np.asarray(jr.per_window["evals"]).tolist()
    want = np.asarray(jr.per_window["metrics"])
    np.testing.assert_allclose(tr.per_window["metrics"], want, rtol=1e-3,
                               atol=1e-6 * float(want[..., 0].max()))


def test_exact_mode_and_meshes_raise_naming_their_roadmap_item(engines, clips):
    """Exact mode itself no longer raises (tests/test_torch_exact.py holds it
    to JAX); what is left to a later slice is every mesh form."""
    _, teng = engines
    content, style = clips
    with pytest.raises(NotImplementedError, match="M8"):
        tlong.transfer_exact(teng, content, style, mesh=object())
    with pytest.raises(NotImplementedError, match="M8"):
        tlong.transfer_longform(teng, content, style, mesh=object())
    with pytest.raises(NotImplementedError, match="M8"):
        teng.optimize_batch(np.zeros((1, W, 16)), np.zeros((1, 16, 4, 4)), mesh=object())


def _cli(tmp_path, *extra):
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
        "assert not any(m == 'jax' or m.startswith('audio_style_transfer_tpu.') "
        "or m == 'audio_style_transfer_tpu' for m in sys.modules);"
        "print('samples', out.shape[0])"
    )
    args = ["tone", "square", "--dir", str(src), "--outdir", str(tmp_path / "out"),
            "--logdir", str(tmp_path / "log"), "--device", "cpu", "--random_init",
            "--batch_size", "4096", "--epochs", "1", "--maxiter", "3", *extra]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return subprocess.run([sys.executable, "-c", code, *args], cwd=tmp_path,
                          env=dict(os.environ, PYTHONPATH=repo), capture_output=True,
                          text=True, timeout=900)


def test_longform_cli_smoke_on_cpu(tmp_path):
    """``--longform --ot_components 4 --gamma 1e-3`` at full width (30 layers
    of 128, random weights) on a 0.6 s clip: 2 windows, one short epoch each,
    ``longform.wav`` in the param-encoded run directory."""
    r = _cli(tmp_path, "--longform", "--ot_components", "4", "--gamma", "1e-3", "--stack", "0")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "OT transform: nmf rec err" in r.stdout, r.stdout
    assert "optimized 0.5s of audio" in r.stdout, r.stdout
    assert f"samples {2 * 4096 - 256}" in r.stdout, r.stdout
    wavs = list((tmp_path / "out").rglob("longform.wav"))
    assert len(wavs) == 1
    assert "longform_True" in wavs[0].parent.name and "cpn_4" in wavs[0].parent.name
    assert "otblend_0.5" in wavs[0].parent.name


@pytest.mark.parametrize("extra", [("--exact",), ("--exact", "--scan_window", "8192")])
def test_exact_cli_flags_raise(tmp_path, extra):
    """(The name dates from when these flags raised.) ``--exact`` and
    ``--scan_window`` run: the 0.6 s clip goes as one window of 8192 samples, or as a scan that pads 9216 samples to two
    windows (tests/test_torch_exact.py holds the results)."""
    r = _cli(tmp_path, "--no_artifacts", "--stack", "0", "--maxiter", "1", *extra)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "NotImplementedError" not in r.stderr
    want = 8192 if extra == ("--exact",) else 9216
    assert f"samples {want}" in r.stdout, r.stdout
