"""Weights carried across: JAX init/save_params -> the port's converter, and
the port's own init_params."""

import os
import re

import numpy as np
import pytest
import torch
from torch_helpers import TOY, jax_params_np

from audio_style_transfer_tpu_torch.ckpt import convert
from audio_style_transfer_tpu_torch.models import wavenet_ae as tw


def test_params_from_numpy_keeps_keys_shapes_values():
    pnp = jax_params_np(**TOY)
    got = convert.params_from_numpy(pnp)
    assert got.keys() == pnp.keys()
    for layer, entry in pnp.items():
        assert got[layer].keys() == entry.keys()
        for k, v in entry.items():
            assert got[layer][k].dtype == torch.float32
            np.testing.assert_array_equal(got[layer][k].numpy(), v)


def test_npz_round_trip_through_jax_save_params(tmp_path):
    from audio_style_transfer_tpu.ckpt.convert import save_params

    pnp = jax_params_np(seed=3, **TOY)
    path = str(tmp_path / "w.npz")
    save_params(path, pnp)
    got = convert.load_params(path)
    assert got.keys() == pnp.keys()
    for layer, entry in pnp.items():
        for k, v in entry.items():
            np.testing.assert_array_equal(got[layer][k].numpy(), v)
    # load_pretrained takes the checkpoint prefix (a sibling .npz) or the .npz.
    save_params(str(tmp_path / "model.ckpt.npz"), pnp)
    assert convert.load_pretrained(str(tmp_path / "model.ckpt")).keys() == pnp.keys()
    assert convert.load_pretrained(path).keys() == pnp.keys()


def test_port_save_params_round_trips_through_jax_bit_for_bit(tmp_path):
    """Weights trained in the port leave as the JAX ``.npz``: port
    save_params -> JAX load_params and the port's own load_pretrained (the
    CLIs' ``--checkpoint_path``), bit for bit; the JAX forward on them equals
    the port's."""
    import jax.numpy as jnp

    from audio_style_transfer_tpu.ckpt.convert import load_params as jload_params
    from audio_style_transfer_tpu.models import wavenet_ae as jw
    from audio_style_transfer_tpu_torch.train import TrainConfig, Trainer

    cfg = dict(num_layers=2, num_stages=2, width=8, skip_width=8, ae_num_layers=2,
               ae_num_stages=2, ae_width=8, ae_hop_length=64, ae_bottleneck_width=4)
    tr = Trainer(TrainConfig(save_every_steps=0), tw.WaveNetAEConfig(**cfg), device="cpu")
    wav = np.random.RandomState(0).uniform(-0.5, 0.5, (2, 256)).astype(np.float32)
    state, _ = tr.step(tr.init_state(), wav)
    path = str(tmp_path / "trained.npz")
    convert.save_params(path, state["params"])
    back = jload_params(path)
    mine = convert.load_pretrained(path)
    assert back.keys() == state["params"].keys() == mine.keys()
    for layer, entry in state["params"].items():
        for k, v in entry.items():
            np.testing.assert_array_equal(np.asarray(back[layer][k]), v.detach().numpy())
            assert torch.equal(mine[layer][k], v.detach())
    want = jw.forward(back, {"wav": jnp.asarray(wav)}, jw.WaveNetAEConfig(**cfg))["loss"]
    got = tw.forward(mine, {"wav": torch.tensor(wav)}, tw.WaveNetAEConfig(**cfg))["loss"]
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_missing_bundle_raises_file_not_found(tmp_path):
    """No ``<ckpt>.npz`` and no bundle: the port's own reader names the
    missing ``.index`` (no TensorFlow, no JAX converter behind it)."""
    prefix = str(tmp_path / "model.ckpt-200000")
    with pytest.raises(FileNotFoundError, match=re.escape(prefix + ".index")):
        convert.load_pretrained(prefix)
    assert not os.path.exists(prefix + ".npz")


def test_port_init_params_same_keys_shapes_and_bound():
    cfg = tw.WaveNetAEConfig(**TOY)
    pnp = jax_params_np(**TOY)
    got = tw.init_params(0, cfg)
    assert got.keys() == pnp.keys()
    for name, (f, cin, cout) in tw._conv_shapes(cfg).items():
        w, b = got[name]["w"], got[name]["b"]
        assert tuple(w.shape) == pnp[name]["w"].shape == (f, cin, cout)
        assert tuple(b.shape) == pnp[name]["b"].shape
        # U(-limit, limit) drawn in float32, so bounded by the float32 limit.
        limit = np.float32(np.sqrt(3.0 / (f * cin)))
        assert float(w.abs().max()) <= limit
        assert float(b.abs().max()) == 0.0
    # Seeded: the same seed gives the same weights, another seed others.
    again = tw.init_params(0, cfg)
    other = tw.init_params(1, cfg)
    assert torch.equal(again["ae_res_1"]["w"], got["ae_res_1"]["w"])
    assert not torch.equal(other["ae_res_1"]["w"], got["ae_res_1"]["w"])
