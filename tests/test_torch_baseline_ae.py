"""The port's baseline spectral AE (models/baseline_ae.py) and its weight
converter against the JAX package's, on the CPU in float32.

Weights: JAX's ``init_baseline_params`` carried across by
``ckpt/convert.py::baseline_params_from_numpy`` (the port's own init draws
other numbers). Geometry: tests/test_baseline_ae.py's shallow spec, plus the
conv helpers at every (kernel, stride) pair of the full nfft_1024 spec.

Tolerances: the same float32 products and sums, taken by oneDNN in the port
and by XLA in JAX, in other orders: outputs, losses and gradients agree to
1e-5 of their largest entry (``RTOL``).

After Adam steps a weight moves by about ``lr`` times the sign of its
gradient (``m / (sqrt(v) + eps)``), so where a gradient element is near zero
and float32 sums in other orders differ in its leading digits, the two
packages may move it by up to ``lr`` in opposite directions. Every weight is
held to twice the most Adam can move one in the steps taken
(:func:`_adam_moves`), and all but 1e-3 of the weights to ``RTOL`` of the
largest weight of their tensor. The bias of a conv that feeds a
training-mode batch norm has a gradient that is zero in exact arithmetic (BN
subtracts the batch mean), so it is all noise, and only the first bound
holds it; each running mean after it takes ``1 - decay`` of the bias at
every forward (the bias moves the batch mean, not the normalised output),
so it is held to ``RTOL`` plus that share of the bias bound at each forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_helpers  # noqa: F401  (two torch threads)

from audio_style_transfer_tpu.models import baseline_ae as jb
from audio_style_transfer_tpu_torch.ckpt.convert import (
    baseline_params_from_numpy,
    baseline_params_to_numpy,
)
from audio_style_transfer_tpu_torch.models import baseline_ae as tb

RTOL = 1e-5

SHALLOW_ENC = (
    ((5, 5), (2, 2), 16),
    ((4, 4), (2, 2), 16),
    ((4, 4), (2, 2), 32),
)
SHALLOW_DEC = (
    ((4, 4), (2, 2), 32),
    ((4, 4), (2, 2), 16),
    ((5, 5), (2, 2), 16),
)
SHALLOW = dict(num_latent=8, pitch_embedding_dim=8, n_fft=64, encoder_spec=SHALLOW_ENC,
               decoder_spec=SHALLOW_DEC)
JHP = jb.BaselineHParams(**SHALLOW)
THP = tb.BaselineHParams(**SHALLOW)


def _close(got, want, rtol=RTOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    scale = max(float(np.abs(want).max()), 1e-30)
    assert err <= rtol * scale, (what, err, scale)


def _jax_params(seed=0, hp=JHP):
    return jax.tree.map(np.array, jb.init_baseline_params(jax.random.PRNGKey(seed), hp))


def _port_model(tree, hp=THP):
    model = tb.BaselineAE(hp)
    model.load_state_dict(baseline_params_from_numpy(tree))
    return model


def _inputs(b=2, h=32, w=16, c=1, seed=0):
    rng = np.random.RandomState(seed)
    return rng.rand(b, h, w, c).astype(np.float32), np.array([60, 64][:b] + [50] * (b - 2))


def _bn_tree(tree):
    """The BN running statistics of a JAX pytree, in layer order."""
    layers = tree["encoder"] + [tree["z_proj"]] + tree["decoder"]
    return [(e["bn_mean"], e["bn_var"]) for e in layers]


def _bn_port(model):
    layers = list(model.encoder) + [model.z_proj] + list(model.decoder)
    return [(m.bn_mean, m.bn_var) for m in layers]


ENC_PAIRS = sorted({(k, s) for k, s, _ in jb.ENCODER_LAYERS})
DEC_PAIRS = sorted({(k, s) for k, s, _ in jb.DECODER_LAYERS})


@pytest.mark.parametrize("hw", [(9, 7), (16, 8)])
@pytest.mark.parametrize("kernel,stride", ENC_PAIRS)
def test_conv2d_matches_lax_at_every_encoder_pair(kernel, stride, hw):
    """SAME conv with a stride: odd sizes make the pads asymmetric."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, *hw, 3).astype(np.float32)
    w = rng.randn(*kernel, 3, 5).astype(np.float32)
    want = jb._conv2d(jnp.asarray(x), jnp.asarray(w), stride)
    got = tb._conv2d(torch.tensor(x).permute(0, 3, 1, 2),
                     torch.tensor(np.transpose(w, (3, 2, 0, 1)).copy()), stride)
    _close(got.permute(0, 2, 3, 1), want, what=(kernel, stride))


@pytest.mark.parametrize("hw", [(5, 4), (8, 8)])
@pytest.mark.parametrize("kernel,stride", DEC_PAIRS)
def test_conv2d_transpose_matches_lax_at_every_decoder_pair(kernel, stride, hw):
    """``lax.conv_transpose`` (SAME, kernel not flipped) against
    ``F.conv_transpose2d`` on the flipped kernel with the crops: the output
    is ``n * stride`` per axis."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, *hw, 3).astype(np.float32)
    w = rng.randn(*kernel, 3, 5).astype(np.float32)
    want = jb._conv2d_transpose(jnp.asarray(x), jnp.asarray(w), stride)
    w_t = np.transpose(w[::-1, ::-1], (2, 3, 0, 1)).copy()
    got = tb._conv2d_transpose(torch.tensor(x).permute(0, 3, 1, 2), torch.tensor(w_t), stride)
    assert got.shape[2:] == (hw[0] * stride[0], hw[1] * stride[1])
    _close(got.permute(0, 2, 3, 1), want, what=(kernel, stride))


def test_transpose_pads_are_xla_s():
    """XLA's SAME pads for a transposed conv, as jax computes them."""
    from jax._src.lax.convolution import _conv_transpose_padding

    for k, s in [(4, 2), (5, 2), (5, 1), (1, 1), (4, 1), (3, 3)]:
        assert tb._conv_transpose_padding(k, s) == tuple(_conv_transpose_padding(k, s, "SAME"))
    assert [tb._conv_transpose_padding(k, s) for k, s in [(4, 2), (5, 2), (5, 1), (1, 1)]] == \
        [(2, 2), (3, 2), (2, 2), (0, 0)]


def test_converter_round_trip_full_geometry():
    """JAX pytree -> state_dict -> pytree, bit for bit, at nfft_1024; every
    parameter and buffer of the port model is named by the pytree."""
    tree = _jax_params(0, jb.BaselineHParams())
    sd = baseline_params_from_numpy(tree)
    model = tb.BaselineAE()
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    back = baseline_params_to_numpy(model.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == np.float32 and np.array_equal(a, b)


def test_init_shapes_and_scale_match_jax():
    """The port's own init: JAX's shapes (through the converter) and the
    Glorot limit of each conv."""
    tree = _jax_params()
    port = baseline_params_to_numpy(tb.BaselineAE(THP, seed=3).state_dict())
    assert jax.tree.structure(port) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(port), jax.tree.leaves(tree)):
        assert a.shape == b.shape
    for e in port["encoder"] + port["decoder"] + [port["z_proj"], port["mag_out"]]:
        kh, kw, cin, cout = e["w"].shape
        limit = np.sqrt(6.0 / (kh * kw * (cin + cout)))
        assert np.abs(e["w"]).max() <= limit and np.abs(e["w"]).max() > 0.5 * limit
    assert not np.any(port["encoder"][0]["bn_mean"]) and np.all(port["encoder"][0]["bn_var"] == 1)


def test_small_helpers_match_jax():
    x = np.linspace(-2, 2, 9).astype(np.float32)
    _close(tb.leaky_relu(torch.tensor(x)), jb.leaky_relu(jnp.asarray(x)), rtol=0)
    for args in [(10.0, 1000, 16000, 512), (10.0, 4000, 16000, 1024), (5.0, 500, 16000, 64)]:
        assert np.array_equal(tb.frequency_weighted_cost_mask(*args),
                              np.asarray(jb.frequency_weighted_cost_mask(*args)))
    tree = _jax_params()
    model = _port_model(tree)
    pitch = np.array([3, 60, 127])
    want = jb.pitch_embeddings(jax.tree.map(jnp.asarray, tree), jnp.asarray(pitch), timesteps=4)
    _close(model.pitch_embeddings(torch.tensor(pitch), timesteps=4), want, rtol=0)


@pytest.mark.parametrize("is_training", [True, False])
def test_encode_decode_match_jax(is_training):
    """z, xhat and, in training, every layer's updated BN statistics; in
    eval the statistics stay."""
    tree = _jax_params()
    if not is_training:  # eval on statistics that are not the init's
        rng = np.random.RandomState(5)
        for mean, var in [(e["bn_mean"], e["bn_var"]) for e in
                          tree["encoder"] + [tree["z_proj"]] + tree["decoder"]]:
            mean += rng.randn(*mean.shape).astype(np.float32) * 0.1
            var *= rng.uniform(0.5, 2.0, var.shape).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    model = _port_model(tree)
    spec, pitch = _inputs()
    z_j, p1 = jb.encode(jparams, jnp.asarray(spec), JHP, is_training=is_training)
    xh_j, p2 = jb.decode(p1, z_j, jnp.asarray(pitch), JHP, is_training=is_training)
    z = model.encode(torch.tensor(spec), is_training=is_training)
    xh = model.decode(z, torch.tensor(pitch), is_training=is_training)
    _close(z, z_j, what="z")
    _close(xh, xh_j, what="xhat")
    for i, ((m, v), (mj, vj)) in enumerate(zip(_bn_port(model), _bn_tree(
            jax.tree.map(np.asarray, p2)))):
        _close(m, mj, what=f"bn_mean {i}")
        _close(v, vj, what=f"bn_var {i}")
    if not is_training:
        for (m, v), (m0, v0) in zip(_bn_port(model), _bn_tree(tree)):
            assert np.array_equal(m.numpy(), m0) and np.array_equal(v.numpy(), v0)


def test_single_value_per_channel_normalises_to_the_bn_bias():
    """Batch 1 at a 1 x 1 map (the full geometry's latent at batch 1): the
    batch variance is 0 and the output is the BN bias, as in JAX."""
    enc = (((4, 4), (2, 2), 8), ((4, 4), (2, 2), 8), ((4, 4), (2, 2), 8))
    dec = (((4, 4), (2, 2), 8), ((4, 4), (2, 2), 8), ((4, 4), (2, 2), 8))
    kw = dict(num_latent=4, pitch_embedding_dim=4, n_fft=16, encoder_spec=enc, decoder_spec=dec)
    jhp, thp = jb.BaselineHParams(**kw), tb.BaselineHParams(**kw)
    tree = _jax_params(1, jhp)
    tree["z_proj"]["bn_bias"] += np.arange(4, dtype=np.float32)
    model = _port_model(tree, thp)
    spec = np.random.RandomState(3).rand(1, 8, 8, 1).astype(np.float32)
    z_j, _ = jb.encode(jax.tree.map(jnp.asarray, tree), jnp.asarray(spec), jhp)
    z = model.encode(torch.tensor(spec))
    assert z.shape == (1, 1, 1, 4)
    _close(z, z_j)
    _close(z.reshape(-1), tree["z_proj"]["bn_bias"], rtol=1e-6)


LOSS_CASES = {
    "mag_only": dict(mag_only=True),
    "dphase": dict(mag_only=False, dphase=True),
    "dphase, cost_phase_mask": dict(mag_only=False, dphase=True, cost_phase_mask=True),
    "cos phase": dict(mag_only=False, dphase=False, phase_loss_coeff=0.5),
    "cos phase, cost_phase_mask": dict(mag_only=False, dphase=False, cost_phase_mask=True),
    "raw_audio": dict(raw_audio=True),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_mse_loss_matches_jax_in_every_branch(case):
    kw = dict(LOSS_CASES[case], n_fft=64, fw_loss_cutoff=2000)
    rng = np.random.RandomState(4)
    x = rng.rand(2, 32, 8, 2).astype(np.float32)
    xh = rng.rand(2, 32, 8, 2).astype(np.float32)
    want = jb.compute_mse_loss(jnp.asarray(x), jnp.asarray(xh), jb.BaselineHParams(**kw))
    got = tb.compute_mse_loss(torch.tensor(x), torch.tensor(xh), tb.BaselineHParams(**kw))
    _close(got, want, what=case)


def _adam_moves(steps: int, b1: float = 0.5, b2: float = 0.999) -> float:
    """The most ``steps`` Adam steps can move a weight, over lr: at step t,
    |m_hat| / sqrt(v_hat) <= (1 - b1) / (1 - b1^t) * sqrt(sum_k b1^2k / b2^k)
    / sqrt((1 - b2) / (1 - b2^t)) (Cauchy-Schwarz over the gradients; 1 at
    t = 1, 1.05 at t = 2 for beta1 0.5)."""
    total = 0.0
    for t in range(1, steps + 1):
        k = np.arange(t)
        total += ((1 - b1) / (1 - b1**t) * np.sqrt(np.sum(b1 ** (2 * k) / b2**k))
                  / np.sqrt((1 - b2) / (1 - b2**t)))
    return float(total)


def _pre_bn_bias(name: str) -> bool:
    return name.endswith(".b") and not name.startswith("mag_out")


STEPS = 3


def test_three_adam_steps_match_train_step_fn():
    """3 steps on one batch against JAX's jitted ``train_step_fn``: the loss
    of each step, then every parameter (Adam's update) and every BN running
    statistic (the forward's update); the loss falls."""
    tree = _jax_params()
    spec, pitch = _inputs()
    step, init_state = jb.train_step_fn(JHP)
    step = jax.jit(step)
    state = init_state(jax.tree.map(jnp.asarray, tree))
    batch = {"spectrogram": jnp.asarray(spec), "pitch": jnp.asarray(pitch)}
    jl = []
    for _ in range(STEPS):
        state, loss = step(state, batch)
        jl.append(float(loss))
    model = _port_model(tree)
    opt = tb.make_optimizer(model)
    tl = [float(tb.train_step(model, opt, torch.tensor(spec), torch.tensor(pitch)))
          for _ in range(STEPS)]
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    assert tl[-1] < tl[0]
    want = baseline_params_from_numpy(jax.tree.map(np.asarray, state["params"]))
    got = model.state_dict()
    assert set(got) == set(want)
    bound = 2 * JHP.learning_rate * _adam_moves(STEPS)
    off, total = 0, 0
    for name in sorted(want):
        d = (got[name] - want[name]).abs()
        assert float(d.max()) <= bound, (name, float(d.max()))
        if name.endswith(".bn_mean") and not name.startswith("mag_out"):
            drift = (1 - tb.BN_DECAY) * sum(2 * JHP.learning_rate * _adam_moves(s)
                                            for s in range(STEPS))
            assert float(d.max()) <= RTOL * float(want[name].abs().max()) + drift, name
        elif not _pre_bn_bias(name):
            off += int((d > RTOL * float(want[name].abs().max())).sum())
            total += d.numel()
    assert off <= 1e-3 * total, (off, total)


def test_eval_interpolations_match_jax():
    tree = _jax_params()
    spec, pitch = _inputs(b=3)
    want = jb.eval_interpolations(jax.tree.map(jnp.asarray, tree), jnp.asarray(spec),
                                  jnp.asarray(pitch), JHP)
    model = _port_model(tree)
    got = tb.eval_interpolations(model, torch.tensor(spec), torch.tensor(pitch))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], what=k)
