"""The port's generation module (generate/fastgen.py) against the JAX
package's, on inputs made with numpy from a seed and JAX's weights carried
across; the incremental decoder against the teacher-forced one; the sample
loop's feedback against JAX's decoder on the same draws.

On the CPU every function here runs the plain loop (one eager call of the
step function per sample); the card replays the same function as a CUDA
graph (tests/test_torch_cuda.py). Geometry: the JAX fastgen test's TINY
config, and the full width at T=1024 for the decoder.

Tolerances, as max|d| against max|ref|: f32 and bf16 weights 1e-4 * max +
1e-5 (residual layers of f32 sums in another order; bf16 weights are f32
products of bf16-rounded weights, the same function in both packages);
int8 1e-3 * max + 1e-4 (x is rounded to bf16 before each product, and a
value an ulp away upstream can round the other way).
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import jax_params_np, n, t, torch_params

from audio_style_transfer_tpu.generate import fastgen as jfastgen
from audio_style_transfer_tpu.models import wavenet_ae as jmodel
from audio_style_transfer_tpu_torch.generate import fastgen
from audio_style_transfer_tpu_torch.models import wavenet_ae as model
from audio_style_transfer_tpu_torch.utils.audio_io import write_wav

jmu = importlib.import_module("audio_style_transfer_tpu.signal.mu_law")

TINY = dict(num_layers=4, num_stages=2, width=8, skip_width=8, ae_num_layers=2,
            ae_num_stages=2, ae_width=8, ae_hop_length=32, ae_bottleneck_width=4)
CFG_J, CFG = jmodel.WaveNetAEConfig(**TINY), model.WaveNetAEConfig(**TINY)
FORMATS = ("float32", "bfloat16", "int8")
REL = {"float32": 1e-4, "bfloat16": 1e-4, "int8": 1e-3}
ABS = {"float32": 1e-5, "bfloat16": 1e-5, "int8": 1e-4}


def bound(ref, fmt="float32"):
    return REL[fmt] * float(np.abs(ref).max()) + ABS[fmt]


def jax_tree(p: dict) -> dict:
    return {k: {m: jnp.asarray(v) for m, v in e.items()} for k, e in p.items()}


def in_format(p: dict, fmt: str):
    """(JAX params, port params) of numpy weights in one format; int8 as
    ``quantize_params_int8(min_size=1)`` in each package (at TINY the default
    size would quantize nothing)."""
    jp, tp = jax_tree(p), torch_params(p)
    if fmt == "bfloat16":
        jp = jax.tree.map(lambda v: v.astype(jnp.bfloat16), jp)
        tp = {k: {m: v.to(torch.bfloat16) for m, v in e.items()} for k, e in tp.items()}
    elif fmt == "int8":
        jp = jfastgen.quantize_params_int8(jp, min_size=1)
        tp = fastgen.quantize_params_int8(tp, min_size=1)
    return jp, tp


def tiny_inputs(seed=0, batch=2, length=128):
    p = jax_params_np(seed, **TINY)
    rng = np.random.RandomState(seed)
    xq = jmu.mu_law_numpy(rng.uniform(-0.9, 0.9, (batch, length))).astype(np.float32)
    _, enc = jmodel.encoder_extracts(jax_tree(p), jnp.asarray(xq), CFG_J)
    return p, xq, np.asarray(enc)


@pytest.mark.parametrize("fmt", FORMATS)
def test_incremental_logits_matches_jax(fmt):
    p, xq, enc = tiny_inputs()
    jp, tp = in_format(p, fmt)
    want = np.asarray(jfastgen.incremental_logits(jp, jnp.asarray(xq), jnp.asarray(enc), CFG_J))
    got = fastgen.incremental_logits(tp, xq, enc, CFG)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (2, 128, 256)
    assert np.abs(n(got) - want).max() <= bound(want, fmt)


@pytest.mark.parametrize("fmt", ("float32", "bfloat16"))
def test_incremental_logits_equal_the_teacher_forced_decoder(fmt):
    """The ring state's oracle, in the port alone: the step loop equals
    ``decode_logits`` (int8 has no teacher-forced decoder in either package)."""
    p, xq, enc = tiny_inputs(seed=4, length=160)
    _, tp = in_format(p, fmt)
    ref = n(model.decode_logits(tp, t(xq), t(enc), CFG))
    got = n(fastgen.incremental_logits(tp, xq, enc, CFG))
    assert np.abs(got - ref).max() <= bound(ref)


def test_incremental_logits_at_full_width_match_jax_decoder():
    """Full width (30 layers of 512, skip 256), T=1024 (2 frames), f32: the
    port's incremental decoder and its teacher-forced one against JAX's
    teacher-forced decoder (JAX's own test holds its incremental decoder to
    that one)."""
    p = jax_params_np(0)
    rng = np.random.RandomState(5)
    xq = np.floor(rng.uniform(-128, 128, (1, 1024))).astype(np.float32)
    enc = (rng.randn(1, 2, 16) * 0.5).astype(np.float32)
    want = np.asarray(jmodel.decode_logits(jax_tree(p), jnp.asarray(xq), jnp.asarray(enc)))
    tp = torch_params(p)
    got = n(fastgen.incremental_logits(tp, xq, enc))
    assert np.abs(got - want).max() <= bound(want)
    assert np.abs(n(model.decode_logits(tp, t(xq), t(enc))) - want).max() <= bound(want)


@pytest.mark.parametrize("fmt", ("float32", "bfloat16"))
def test_encode_matches_jax(fmt):
    p = jax_params_np(1, **TINY)
    jp, tp = in_format(p, fmt)
    wav = np.random.RandomState(1).uniform(-0.5, 0.5, (2, 100)).astype(np.float32)
    want = jfastgen.encode(wav, jp, sample_length=100, cfg=CFG_J)
    got = fastgen.encode(wav, tp, sample_length=100, cfg=CFG)
    assert isinstance(got, np.ndarray) and got.shape == want.shape == (2, 3, 4)
    assert np.abs(got - want).max() <= bound(want)
    one = fastgen.encode(wav[0], tp, sample_length=100, cfg=CFG)
    assert one.shape == (1, 3, 4)
    np.testing.assert_array_equal(one[0], got[0])


@pytest.mark.parametrize("config,min_size", [("tiny", 1), ("full", 65536)])
def test_quantize_params_int8_matches_jax(config, min_size):
    p = jax_params_np(2, **(TINY if config == "tiny" else {}))
    want = jfastgen.quantize_params_int8(jax_tree(p), min_size=min_size)
    got = fastgen.quantize_params_int8(torch_params(p), min_size=min_size)
    assert want.keys() == got.keys()
    quantized = 0
    for name, entry in want.items():
        assert entry.keys() == got[name].keys(), name
        if "w_q" not in entry:
            np.testing.assert_array_equal(n(got[name]["w"]), np.asarray(entry["w"]))
            continue
        quantized += 1
        assert got[name]["w_q"].dtype == torch.int8
        np.testing.assert_array_equal(got[name]["w_q"].numpy(), np.asarray(entry["w_q"]))
        np.testing.assert_array_equal(got[name]["w_scale"].numpy(), np.asarray(entry["w_scale"]))
        np.testing.assert_array_equal(n(got[name]["b"]), np.asarray(entry["b"]))
    # Full width: the dilated convs, res, skip, skip_start, out1 and logits.
    assert quantized == (len(p) if config == "tiny" else 3 * 30 + 3)


@pytest.mark.parametrize("fmt", FORMATS)
def test_sampled_bins_are_the_argmax_of_jax_logits_on_the_same_draws(fmt):
    """The feedback loop's oracle. The port samples audio a; its uniforms U are
    drawn again from a generator of the same seed (one [hop, B, 256] draw per
    hop, floored at the smallest normal: sample_loop's contract). JAX's
    teacher-forced incremental decoder on mu_law(a) gives the logits JAX's own
    loop computes after drawing the same samples. Each bin the port drew is
    argmax(logits - log(-log U)) of those logits, except where the top two
    scores lie within the tolerance."""
    p, _, enc = tiny_inputs(seed=6)
    jp, tp = in_format(p, fmt)
    audio = fastgen.sample_loop(tp, enc[:, :3], torch.Generator().manual_seed(3), CFG)
    a = audio.numpy()
    gen = torch.Generator().manual_seed(3)
    u = torch.cat([torch.rand((32, 2, 256), generator=gen) for _ in range(3)])
    u = u.clamp(min=torch.finfo(torch.float32).tiny).numpy().transpose(1, 0, 2)  # [B, T, 256]
    assert a.shape == (2, 3 * 32)
    table = fastgen._feedback_tables("cpu")[0].numpy()
    bins = np.array([[np.flatnonzero(table == v)[0] for v in row] for row in a])
    logits = np.asarray(jfastgen.incremental_logits(
        jp, jmu.mu_law(jnp.asarray(a)), jnp.asarray(enc[:, :3]), CFG_J))
    assert u.min() > 0 and u.max() < 1
    scores = logits - np.log(-np.log(u))
    top2 = np.sort(scores, axis=-1)[..., -2:]
    near_tie = top2[..., 1] - top2[..., 0] <= 2 * bound(logits, fmt)
    agree = bins == scores.argmax(-1)
    assert np.all(agree | near_tie)
    assert near_tie.mean() < 0.05


@pytest.mark.parametrize("kwargs", [{}, {"dtype": torch.bfloat16}, {"quantize": "int8"}])
def test_synthesize_is_deterministic_given_the_seed_and_makes_audio(kwargs):
    p = torch_params(jax_params_np(2, **TINY))
    enc = np.random.RandomState(2).randn(2, 3, 4).astype(np.float32) * 0.1
    a = fastgen.synthesize(enc, params=p, cfg=CFG, seed=7, **kwargs)
    b = fastgen.synthesize(enc, params=p, cfg=CFG, seed=7, **kwargs)
    c = fastgen.synthesize(enc, params=p, cfg=CFG, seed=8, **kwargs)
    assert isinstance(a, np.ndarray) and a.shape == (2, 3 * 32)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert np.all(np.isfinite(a)) and np.abs(a).max() <= 1.0 and np.abs(a).max() > 0


def test_synthesize_refuses_what_jax_refuses():
    p = torch_params(jax_params_np(2, **TINY))
    enc = np.zeros((1, 1, 4), np.float32)
    with pytest.raises(ValueError, match="mutually exclusive"):
        fastgen.synthesize(enc, params=p, cfg=CFG, dtype=torch.bfloat16, quantize="int8")
    with pytest.raises(ValueError, match="unsupported quantize"):
        fastgen.synthesize(enc, params=p, cfg=CFG, quantize="int4")
    with pytest.raises(ValueError):
        fastgen.synthesize(enc, cfg=CFG)


def test_load_batch_and_save_batch_match_jax(tmp_path):
    p1, p2 = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    write_wav(p1, np.linspace(-0.5, 0.5, 100, dtype=np.float32), 16000)
    write_wav(p2, np.ones(50, np.float32) * 0.1, 16000)
    for sample_length in (200, 70):
        got = fastgen.load_batch([p1, p2], sample_length=sample_length)
        np.testing.assert_array_equal(got, jfastgen.load_batch([p1, p2], sample_length))
    e1, e2 = str(tmp_path / "a.npy"), str(tmp_path / "b.npy")
    np.save(e1, np.ones((3, 4), np.float32))
    np.save(e2, np.ones((2, 4), np.float32) * 2)
    got = fastgen.load_batch([e1, e2])
    assert got.shape == (2, 3, 4) and np.all(got[1, 2] == 0)
    np.testing.assert_array_equal(got, jfastgen.load_batch([e1, e2]))
    audio = np.random.RandomState(0).uniform(-1, 1, (2, 64)).astype(np.float32)
    mine = [str(tmp_path / "x.wav"), str(tmp_path / "y.wav")]
    theirs = [str(tmp_path / "jx.wav"), str(tmp_path / "jy.wav")]
    fastgen.save_batch(audio, mine)
    jfastgen.save_batch(audio, theirs)
    for a, b in zip(mine, theirs):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    assert all(os.path.exists(q) for q in mine)


def test_cond_bytes_at_the_full_geometry():
    cfg = model.WaveNetAEConfig()
    assert fastgen.cond_bytes(cfg, 1, 1) == 123904
    assert fastgen.cond_bytes(cfg, 1, 1875) == 232320000
    enc = torch.zeros((2, 3, 16))
    cond = fastgen._precompute_cond(model.init_params(0, cfg), cfg, enc)
    assert cond.numel() * 4 == fastgen.cond_bytes(cfg, 2, 3)
