"""The port's training CLI (cli/train.py) against the JAX CLI's flags, and
runs of it on the CPU at full width (30 + 30 layers, random weights) on a
synthetic TFRecord: 2 iterations write ckpt-2 and ``--resume`` continues from
it. About 3 s a step at 1 x 512 samples on 2 threads.
"""

import os

import numpy as np
import pytest
import torch

from audio_style_transfer_tpu.cli import train as jtrain
from audio_style_transfer_tpu_torch.cli import train
from audio_style_transfer_tpu_torch.data import build_example, write_tfrecord
from audio_style_transfer_tpu_torch.train import TrainConfig, Trainer


def _options(parser) -> dict:
    return {a.dest: (tuple(a.option_strings), a.default) for a in parser._actions}


def test_parser_has_the_jax_flags_plus_device():
    got, want = _options(train.build_parser()), _options(jtrain.build_parser())
    assert got.pop("device") == (("--device",), "cuda")
    assert got == want


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    rng = np.random.RandomState(0)
    path = str(tmp_path_factory.mktemp("data") / "train.tfrecord")
    write_tfrecord(path, [build_example({
        "note_str": f"n{i}".encode(), "pitch": np.array([60 + i], np.int64),
        "audio": (rng.uniform(-0.5, 0.5, 2048)).astype(np.float32)}) for i in range(3)])
    return path


def test_cli_trains_checkpoints_and_resumes_on_the_cpu(records, tmp_path, capsys):
    logdir = str(tmp_path / "log")
    common = ["--train_path", records, "--logdir", logdir, "--total_batch_size", "1",
              "--sample_length", "512", "--device", "cpu"]
    train.main(common + ["--num_iters", "2"])
    out = capsys.readouterr().out
    assert "ckpt-2 at step 2" in out and ("native reader" in out or "python reader" in out)
    assert os.listdir(logdir) == ["ckpt-2"]
    tr = Trainer(TrainConfig(logdir=logdir), device="cpu")
    first = tr.restore()
    assert first["step"] == 2
    adam = first["opt_state"].state[first["params"]["logits"]["w"]]
    assert float(adam["exp_avg_sq"].abs().max()) > 0.0
    train.main(common + ["--num_iters", "1", "--resume"])
    assert sorted(os.listdir(logdir)) == ["ckpt-2", "ckpt-3"]
    second = tr.restore()
    assert second["step"] == 3
    w2, w3 = first["params"]["logits"]["w"], second["params"]["logits"]["w"]
    assert not torch.equal(w2, w3) and bool(torch.isfinite(w3).all())


def test_cli_refuses_what_it_cannot_do(records, tmp_path, monkeypatch):
    """No --train_path; --num_devices beyond the visible cards on cuda. What
    it can do since data parallelism: --num_devices 2 --device cpu spawns 2
    gloo ranks that train 2 steps on a global batch of 2, and rank 0 alone
    writes the one checkpoint."""
    with pytest.raises(RuntimeError, match="train_path"):
        train.main(["--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="--num_devices 2: 0 CUDA device"):
            train.main(["--train_path", records, "--num_devices", "2",
                        "--logdir", str(tmp_path)])
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    logdir = str(tmp_path / "dp")
    train.main(["--train_path", records, "--num_devices", "2", "--device", "cpu",
                "--logdir", logdir, "--total_batch_size", "2", "--sample_length", "512",
                "--num_iters", "2"])
    assert os.listdir(logdir) == ["ckpt-2"]
    state = Trainer(TrainConfig(logdir=logdir), device="cpu").restore()
    assert state["step"] == 2 and bool(torch.isfinite(state["params"]["logits"]["w"]).all())
