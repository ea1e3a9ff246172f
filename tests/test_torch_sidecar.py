"""The port's side-car modules against the JAX package's, on the CPU:
utils/profiling.py, analysis/summaries.py, the viz functions of
analysis/viz.py, cli/output_grams.py, and the two baseline CLIs
(cli/baseline_train.py, cli/baseline_save_embeddings.py) at the full
nfft_1024 geometry on batches of one.

Tolerances: host numpy code copied from JAX is held bit for bit; grams of
the 30-layer encoder to 1e-4 of their largest entry (float32 sums of 4096
rows in another order, then an l2 normalisation); inverse-specgram audio to
1e-4 of its peak (tests/test_torch_specgram.py's bound).
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import jax_params_np, torch_params

from audio_style_transfer_tpu.analysis import summaries as jsum
from audio_style_transfer_tpu.utils import profiling as jprof
from audio_style_transfer_tpu_torch.analysis import summaries as tsum
from audio_style_transfer_tpu_torch.utils import profiling as tprof


def test_metrics_logger_writes_what_jax_s_does(tmp_path):
    for mod, sub in ((tprof, "port"), (jprof, "jax")):
        with mod.MetricsLogger(str(tmp_path / sub)) as m:
            m.log(0, loss=1.5, style_loss=0.2)
            m.log(np.int64(1), loss=np.float32(1.25))
    port = open(tmp_path / "port" / "metrics.jsonl").read()
    assert port == open(tmp_path / "jax" / "metrics.jsonl").read()
    assert [json.loads(line) for line in port.splitlines()] == [
        {"step": 0, "loss": 1.5, "style_loss": 0.2}, {"step": 1, "loss": 1.25}]


def test_device_trace_writes_a_chrome_trace(tmp_path):
    x = torch.ones(64, 64)
    with tprof.device_trace(str(tmp_path / "trace")) as logdir:
        torch.tanh(x @ x.T).sum()
    assert logdir == str(tmp_path / "trace")
    (path,) = glob.glob(os.path.join(logdir, "trace-*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)


def test_profiling_leaves_out_what_has_no_counterpart():
    assert not hasattr(tprof, "enable_compile_cache")
    assert not hasattr(tprof, "summarize_xplane")


def test_form_image_grid_and_metrics_equal_jax():
    rng = np.random.RandomState(0)
    batch = rng.rand(6, 4, 5, 2).astype(np.float32)
    np.testing.assert_array_equal(tsum.form_image_grid(batch, [2, 3], [4, 5], 2),
                                  jsum.form_image_grid(batch, [2, 3], [4, 5], 2))
    flat = batch.reshape(6, -1)
    np.testing.assert_array_equal(tsum.form_image_grid(flat, [3, 2], [4, 5], 2),
                                  jsum.form_image_grid(flat, [3, 2], [4, 5], 2))
    for bad in [(batch, [2, 2], [4, 5], 2), (batch, [2, 3], [5, 4], 2),
                (flat, [2, 3], [4, 4], 2), (batch[0], [1, 1], [4, 5], 2)]:
        with pytest.raises(ValueError):
            tsum.form_image_grid(*bad)
    logits = rng.randn(12, 8)
    for labels in (rng.randint(0, 8, 12), np.eye(8)[rng.randint(0, 8, 12)]):
        assert tsum.softmax_metrics(logits, labels) == jsum.softmax_metrics(logits, labels)
    a, b = rng.randn(5, 3), rng.randn(5, 3)
    assert tsum.l2_metrics(a, b) == jsum.l2_metrics(a, b)


def test_specgram_summaries_write_jax_s_files(tmp_path):
    """Grids of both channels and the (mag, dphase) branch's audio, which is
    deterministic: the port's wavs against JAX's."""
    from audio_style_transfer_tpu.models.baseline_ae import BaselineHParams as JHP
    from audio_style_transfer_tpu.signal.specgram import specgram
    from audio_style_transfer_tpu_torch.models.baseline_ae import BaselineHParams as THP
    from audio_style_transfer_tpu_torch.utils.audio_io import read_wav

    kw = dict(n_fft=64, hop_length=16, mag_only=False)
    rng = np.random.RandomState(1)
    clips = rng.uniform(-0.5, 0.5, (4, 1024)).astype(np.float32)
    spec = np.stack([np.asarray(specgram(jnp.asarray(c), n_fft=64, hop_length=16))
                     for c in clips])
    tsum.specgram_summaries(spec, "val/x y", THP(**kw), str(tmp_path / "port"),
                            rows=2, columns=2, device="cpu")
    jsum.specgram_summaries(spec, "val/x y", JHP(**kw), str(tmp_path / "jax"),
                            rows=2, columns=2)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert "mag_val_x_y.png" in names and "phase_val_x_y.png" in names
    for n in names:
        if n.endswith(".wav"):
            got, _ = read_wav(str(tmp_path / "port" / n))
            want, _ = read_wav(str(tmp_path / "jax" / n))
            assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max() + 1 / 32768


def test_viz_functions_write_their_figures(tmp_path):
    from audio_style_transfer_tpu_torch.analysis import viz

    figdir = str(tmp_path)
    rng = np.random.RandomState(2)
    aud = rng.randn(512)
    enc = np.abs(rng.rand(2, 512, 8))
    viz.vis_actis(aud, enc, figdir, 1, layers=[0, 5], output_file=True)
    viz.vis_actis_ens(aud, enc, figdir, 2, layer_ids=[0, 5], dspl=128)
    viz.vis_mats(rng.rand(2, 8, 8), rng.rand(2, 8, 8), [0, 1], figdir=figdir,
                 srcname="s", trgname="t")
    mats = rng.rand(4, 6, 6)
    inten = viz.show_inten(mats, 3, figdir)
    for name in ("f-1.png", "f-1.wav", "fe-2.png", "mats_plt.png", "int3.png"):
        assert os.path.getsize(os.path.join(figdir, name)) > 0, name
    from audio_style_transfer_tpu.analysis.viz import show_inten

    np.testing.assert_array_equal(inten, show_inten(mats, 4, figdir))


@pytest.fixture(scope="module")
def tone_dir(tmp_path_factory):
    from audio_style_transfer_tpu_torch.utils.audio_io import write_wav

    d = tmp_path_factory.mktemp("src")
    t = np.arange(3 * 4096 + 100) / 16000
    write_wav(str(d / "tone.wav"), (0.5 * np.sin(2 * np.pi * 220 * t)).astype(np.float32),
              16000)
    return d


def test_output_grams_window_grams_match_jax(tone_dir):
    """The CLI's per-window function at the full stack (L = 30 taps) on the
    same weights as JAX's engine: 3 windows of 4096 samples."""
    from audio_style_transfer_tpu.transfer import StyleTransfer as JST
    from audio_style_transfer_tpu.transfer import TransferSpec as JSpec
    from audio_style_transfer_tpu_torch.cli import output_grams
    from audio_style_transfer_tpu_torch.transfer import StyleTransfer, TransferSpec

    pnp = jax_params_np(0)
    audios = output_grams.read_file(str(tone_dir / "tone.wav"), 4096)
    assert len(audios) == 3
    port = StyleTransfer(TransferSpec(stack=None, batch_size=4096, write_artifacts=False,
                                      device="cpu"), torch_params(pnp))
    got = output_grams.window_grams(port, audios)
    jax_engine = JST(JSpec(stack=None, batch_size=4096, write_artifacts=False),
                     jax.tree.map(jnp.asarray, pnp))
    for g, aud in zip(got, audios):
        want = np.asarray(jax_engine.get_embeds(aud, is_content=False))
        assert g.shape == want.shape == (128, 30, 30)
        assert np.abs(g - want).max() <= 1e-4 * np.abs(want).max()


def test_output_grams_main_draws_a_grid_per_window(tone_dir, tmp_path, capsys):
    from audio_style_transfer_tpu_torch.cli import output_grams

    args = output_grams.build_parser().parse_args(["tone"])
    assert (args.stack, args.length, args.channels, args.device) == (None, 16384, 128, "cuda")
    output_grams.main(["tone", "--srcdir", str(tone_dir), "--figdir", str(tmp_path / "fig"),
                       "--stack", "0", "--length", "4096", "--channels", "16", "--random_init",
                       "--device", "cpu"])
    found = sorted(os.path.basename(p) for p in
                   glob.glob(str(tmp_path / "fig" / "**" / "gram-ep*.png"), recursive=True))
    assert found == ["gram-ep0.png", "gram-ep1.png", "gram-ep2.png"]
    assert capsys.readouterr().out.count("gram grid saved") == 3


def test_baseline_clis_train_then_encode(tmp_path, capsys):
    """cli/baseline_train.py for 2 steps of one 64000-sample clip at the full
    nfft_1024 geometry (a checkpoint at step 2, the metrics file), then
    cli/baseline_save_embeddings.py from it: each z [1, 1, 1984] equals the
    eval-mode encode of the checkpoint's model."""
    from audio_style_transfer_tpu_torch.cli import baseline_save_embeddings, baseline_train
    from audio_style_transfer_tpu_torch.data import (
        NSynthDataset,
        build_example,
        write_tfrecord,
    )
    from audio_style_transfer_tpu_torch.models.baseline_ae import BaselineAE, BaselineHParams

    rng = np.random.RandomState(0)
    path = str(tmp_path / "t.tfrecord")
    write_tfrecord(path, [build_example({
        "note_str": f"n{i}".encode(), "pitch": np.array([60 + i]),
        "audio": rng.uniform(-0.5, 0.5, 64000).astype(np.float32)}) for i in range(2)])
    assert baseline_train.build_parser().parse_args([]).device == "cuda"
    logdir = str(tmp_path / "log")
    baseline_train.main(["--train_path", path, "--logdir", logdir, "--batch_size", "1",
                         "--num_iters", "2", "--log_every", "1", "--save_every", "2",
                         "--device", "cpu"])
    out = capsys.readouterr().out
    assert "trained 2 steps on cpu" in out and out.count(" loss ") >= 2
    assert [json.loads(line)["step"] for line in open(os.path.join(logdir, "metrics.jsonl"))] \
        == [1, 2]
    saved = torch.load(os.path.join(logdir, "ckpt-2"), weights_only=True)
    assert saved["step"] == 2 and "state" in saved["opt"]
    baseline_save_embeddings.main(["--tfrecord_path", path, "--checkpoint_dir", logdir,
                                   "--savedir", str(tmp_path / "emb"), "--batch_size", "1",
                                   "--device", "cpu"])
    model = BaselineAE(BaselineHParams(batch_size=1))
    model.load_state_dict(saved["model"])
    batches = NSynthDataset(path, is_training=False).get_baseline_batch(
        BaselineHParams(batch_size=1), device="cpu")
    for batch in batches:
        key = batch["key"][0].decode()
        got = np.load(str(tmp_path / "emb" / f"{key}_baseline_z.npz"))
        with torch.no_grad():
            z = model.encode(torch.from_numpy(batch["spectrogram"]), is_training=False)
        assert got["z"].shape == (1, 1, 1984)
        np.testing.assert_array_equal(got["z"], z[0].numpy())
        assert int(got["pitch"]) == int(batch["pitch"][0])
