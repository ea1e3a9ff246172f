"""Weights carried across: JAX init/save_params -> the port's converter, and
the port's own init_params."""

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


def test_tf1_bundle_error_names_the_jax_converter(tmp_path):
    with pytest.raises(FileNotFoundError, match="convert_tf1_checkpoint"):
        convert.load_pretrained(str(tmp_path / "model.ckpt-200000"))


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
