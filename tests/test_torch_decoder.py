"""The port's decoder half (models/wavenet_ae.py ``decode_logits``) and the
helpers generation needs (signal/mu_law.py ``mu_law_quantize``, ops/conv.py
``shift_right`` / ``condition``, utils/audio_io.py ``load_audio_mono`` /
``trim_for_encoding``) against the JAX package, on inputs made with numpy
from a seed and JAX's weights carried across.

Geometry: the JAX fastgen test's TINY config (tests/test_fastgen.py).
Tolerance of the logits: max|d| <= 1e-4 * max|ref| + 1e-5, for 30 (here 4)
residual layers of f32 sums taken in another order; bf16 weights are the
same function (f32 products of bf16-rounded weights) and keep the bound.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import jax_params_np, n, t, torch_params

from audio_style_transfer_tpu.models import wavenet_ae as jmodel
from audio_style_transfer_tpu.ops import conv as jconv
from audio_style_transfer_tpu.utils import audio_io as jio
from audio_style_transfer_tpu_torch.models import wavenet_ae as model
from audio_style_transfer_tpu_torch.ops import conv
from audio_style_transfer_tpu_torch.utils import audio_io

# Both packages' signal/__init__ export a function named mu_law.
jmu = importlib.import_module("audio_style_transfer_tpu.signal.mu_law")
mu = importlib.import_module("audio_style_transfer_tpu_torch.signal.mu_law")

TINY = dict(num_layers=4, num_stages=2, width=8, skip_width=8, ae_num_layers=2,
            ae_num_stages=2, ae_width=8, ae_hop_length=32, ae_bottleneck_width=4)
FORMATS = ("float32", "bfloat16")


def bound(ref, rel=1e-4, abs_=1e-5):
    return rel * float(np.abs(ref).max()) + abs_


def tiny_inputs(seed=0, batch=2, length=128):
    """JAX's TINY weights (numpy), a floor-quantized input and its encoding."""
    p = jax_params_np(seed, **TINY)
    rng = np.random.RandomState(seed)
    xq = jmu.mu_law_numpy(rng.uniform(-0.9, 0.9, (batch, length))).astype(np.float32)
    jp = {k: {m: jnp.asarray(v) for m, v in e.items()} for k, e in p.items()}
    _, enc = jmodel.encoder_extracts(jp, jnp.asarray(xq), jmodel.WaveNetAEConfig(**TINY))
    return p, xq, np.asarray(enc)


def as_format(p: dict, fmt: str):
    """(JAX params, port params) of numpy weights in one format."""
    jp = {k: {m: jnp.asarray(v) for m, v in e.items()} for k, e in p.items()}
    tp = torch_params(p)
    if fmt == "bfloat16":
        jp = {k: {m: v.astype(jnp.bfloat16) for m, v in e.items()} for k, e in jp.items()}
        tp = {k: {m: v.to(torch.bfloat16) for m, v in e.items()} for k, e in tp.items()}
    return jp, tp


def test_mu_law_quantize_matches_jax():
    x = np.random.RandomState(0).uniform(-1, 1, 4096).astype(np.float32)
    x[:5] = [0.0, -1.0, 1.0, 1e-7, -1e-7]
    got = mu.mu_law_quantize(t(x)).numpy()
    # A floor of a value that lands on an integer within rounding can move by one.
    for want in (np.asarray(jmu.mu_law_quantize(jnp.asarray(x))), mu.mu_law_numpy(x)):
        assert np.mean(got != want) < 1e-3 and np.abs(got - want).max() <= 1.0
    np.testing.assert_array_equal(got[:5], [0.0, -128.0, 128.0, 0.0, -1.0])


def test_shift_right_and_condition_match_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 12, 3).astype(np.float32)
    enc = rng.randn(2, 4, 3).astype(np.float32)
    np.testing.assert_array_equal(n(conv.shift_right(t(x))), np.asarray(jconv.shift_right(x)))
    np.testing.assert_array_equal(n(conv.condition(t(x), t(enc))),
                                  np.asarray(jconv.condition(x, enc)))
    with pytest.raises(ValueError):
        conv.condition(t(x), t(enc[:, :, :2]))


@pytest.mark.parametrize("length,sample_length", [(100, 64000), (1000, 700), (1024, 1024)])
def test_audio_loaders_match_jax(tmp_path, length, sample_length):
    rng = np.random.RandomState(length)
    path = str(tmp_path / "a.wav")
    audio_io.write_wav(path, rng.uniform(-0.5, 0.5, (2, length)).astype(np.float32), 16000)
    got = audio_io.load_audio_mono(path, sample_length)
    np.testing.assert_array_equal(got, jio.load_audio_mono(path, sample_length))
    assert got.ndim == 1 and got.shape[0] == min(length, sample_length)
    wav = rng.randn(3, length).astype(np.float32)
    for data in (wav, wav[0]):
        g, gl = audio_io.trim_for_encoding(data, sample_length, 32)
        w, wl = jio.trim_for_encoding(data, sample_length, 32)
        assert gl == wl and gl % 32 == 0
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("fmt", FORMATS)
def test_decode_logits_matches_jax(fmt):
    p, xq, enc = tiny_inputs()
    jp, tp = as_format(p, fmt)
    cfg_j, cfg_t = jmodel.WaveNetAEConfig(**TINY), model.WaveNetAEConfig(**TINY)
    want = np.asarray(jmodel.decode_logits(jp, jnp.asarray(xq), jnp.asarray(enc), cfg_j))
    got = model.decode_logits(tp, t(xq), t(enc), cfg_t)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 128, 256)
    assert np.abs(n(got) - want).max() <= bound(want)


def test_decoder_dilations_match_jax():
    for kw in ({}, TINY):
        j, p = jmodel.WaveNetAEConfig(**kw), model.WaveNetAEConfig(**kw)
        assert [p.dilation(i) for i in range(p.num_layers)] == \
               [j.dilation(i) for i in range(j.num_layers)]


def test_decode_logits_rejects_a_ragged_encoding():
    p, xq, enc = tiny_inputs()
    with pytest.raises(ValueError):
        model.decode_logits(torch_params(p), t(xq[:, :99]), t(enc),
                            model.WaveNetAEConfig(**TINY))
