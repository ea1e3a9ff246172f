"""The port's composed reference-numerics parity (TF loss + SciPy
L-BFGS-B against the port's engine) against the JAX package's module.

The TF oracle is the JAX module's, copied: on the same numpy weights (JAX's
toy ``PRNGKey(42)`` draw, carried across) it gives the same taps and targets
bit for bit, and they agree with the port's encoder. The oracle's loss and
gradient agree with the port's ``transfer_loss`` on the same targets. One
short ``run_composed`` on the CPU stays in tier 1; the JAX test's full toy
run is ``slow``, as there. TensorFlow is the oracle: without it every test
here skips, as JAX's test does.
"""

import ast
import os

import numpy as np
import pytest
import torch
from torch_helpers import jax_params_np, parser_defaults, torch_params

tf = pytest.importorskip("tensorflow")

from audio_style_transfer_tpu.transfer import composed_parity as jcp  # noqa: E402
from audio_style_transfer_tpu_torch.models.wavenet_ae import (  # noqa: E402
    WaveNetAEConfig,
    encoder_extracts,
)
from audio_style_transfer_tpu_torch.signal.mu_law import mu_law_numpy  # noqa: E402
from audio_style_transfer_tpu_torch.transfer import composed_parity as tcp  # noqa: E402
from audio_style_transfer_tpu_torch.transfer.losses import LossSpec, transfer_loss  # noqa: E402

TOY_CFG = dict(num_layers=2, num_stages=2, width=8, skip_width=8, ae_num_layers=4,
               ae_num_stages=2, ae_width=8, ae_hop_length=64, ae_bottleneck_width=4)
SPEC = LossSpec(cont_lyr_ids=(3,), style_layer_ids=(0, 1, 2, 3), cnt_channels=8,
                nb_channels=8, lambd=10.0, gamma=0.01)
T = 4096
# TF's convs against the port's plain trunk on the CPU, float32 (measured
# 2.3e-7 of a tap's peak at most).
TAP_TOL = 1e-5
# The TF loss against the port's on the same targets and iterate, float32
# (measured: value 1.9e-7, gradient 3.4e-6 relative L2).
VALUE_RTOL = 1e-6
GRAD_RTOL = 2e-5
TOL = 0.01


@pytest.fixture(scope="module")
def toy_weights():
    """JAX's toy weights as numpy, the oracle's input."""
    return jax_params_np(42, **TOY_CFG)


def _quantized(seed: int) -> np.ndarray:
    return mu_law_numpy(tcp._noise(seed, T)[None]).astype(np.float32)


def test_oracle_taps_and_targets_equal_jax_modules_bit_for_bit(toy_weights):
    cfg = WaveNetAEConfig(**TOY_CFG)
    x = tf.constant(_quantized(0))
    got = tcp.tf_encoder_extracts(tf, toy_weights, x, cfg)
    want = jcp.tf_encoder_extracts(tf, toy_weights, x, cfg)
    assert len(got) == len(want) == cfg.ae_num_layers + 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    for a, b in zip(tcp.tf_targets(tf, got, SPEC), jcp.tf_targets(tf, want, SPEC)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    ref = tcp.TFComposedReference(tf, toy_weights, cfg, SPEC, T)
    jref = jcp.TFComposedReference(tf, toy_weights, cfg, SPEC, T)
    np.testing.assert_array_equal(ref.style_phi(tcp._noise(1, 2 * T)),
                                  jref.style_phi(jcp._noise(1, 2 * T)))
    np.testing.assert_array_equal(ref.embeds(tcp._noise(2, T)), jref.embeds(jcp._noise(2, T)))


def test_oracle_taps_match_the_ports_encoder(toy_weights):
    cfg = WaveNetAEConfig(**TOY_CFG)
    xq = _quantized(0)
    got = tcp.tf_encoder_extracts(tf, toy_weights, tf.constant(xq), cfg)
    with torch.no_grad():
        want, _ = encoder_extracts(torch_params(toy_weights), torch.tensor(xq), cfg)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        b = b.numpy()
        err = float(np.max(np.abs(a.numpy() - b)) / np.max(np.abs(b)))
        assert err <= TAP_TOL, (i, err)


def test_oracle_loss_and_gradient_match_the_ports_transfer_loss(toy_weights):
    """``build_loss`` at one iterate with gamma 0.01 (the STFT regularizer on)
    against ``transfer_loss`` and its autograd gradient, both on the oracle's
    targets."""
    cfg = WaveNetAEConfig(**TOY_CFG)
    ref = tcp.TFComposedReference(tf, toy_weights, cfg, SPEC, T)
    phi_c = ref.embeds(tcp._noise(0, T))
    phi = ref.embeds(tcp._noise(0, T), is_content=False) + ref.style_phi(tcp._noise(1, 2 * T))
    phi = phi / np.sqrt(np.sum(np.square(phi), axis=(1, 2), keepdims=True))
    vg = ref.build_loss(phi_c, phi)
    x = np.random.RandomState(5).uniform(-64, 64, (1, T)).astype(np.float32)
    v_tf, g_tf = ref.loss_grad_np(x.astype(np.float64))
    assert v_tf == float(vg(tf.constant(x))[0].numpy())

    xv = torch.tensor(x, requires_grad=True)
    v = transfer_loss(torch_params(toy_weights), xv, torch.tensor(phi_c), torch.tensor(phi),
                      cfg, SPEC)[0]
    (g,) = torch.autograd.grad(v, xv)
    v = float(v.detach())
    v_rel = abs(v - v_tf) / abs(v_tf)
    g_rel = float(np.linalg.norm(g.numpy().reshape(-1) - g_tf) / np.linalg.norm(g_tf))
    assert v_rel <= VALUE_RTOL, (v, v_tf)
    assert g_rel <= GRAD_RTOL, g_rel


def _jax_record_keys() -> list:
    """The keys of JAX's run_composed records, read from its source."""
    with open(jcp.__file__) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "run_composed")
    record = next(n.args[0] for n in ast.walk(fn) if isinstance(n, ast.Call)
                  and getattr(n.func, "attr", None) == "append"
                  and isinstance(n.args[0], ast.Dict))
    return [k.value for k in record.keys]


def test_run_composed_toy_on_the_cpu():
    """One short composed run on the CPU, the port's own toy weights: the
    records carry JAX's keys, and TF's loss at our final iterate reproduces
    our final loss (the same function)."""
    records = tcp.run_composed(toy=True, seeds=1, epochs=2, maxiter=30, device="cpu")
    assert len(records) == 1
    r = records[0]
    assert list(r) == _jax_record_keys()
    assert (r["t"], r["toy"], r["epochs"], r["maxiter"]) == (T, True, 2, 30)
    assert all(np.isfinite(r[k]) for k in ("ours", "composed", "tf_at_ours", "ours_at_composed"))
    assert abs(r["tf_at_ours"] - r["ours"]) <= 5e-3 * abs(r["ours"]), r


def test_main_flags_mirror_jax_plus_device(monkeypatch):
    """The port's flags and defaults are JAX's plus ``--device`` (default
    cuda)."""
    jax_flags = parser_defaults(jcp.main, monkeypatch, [])
    port_flags = parser_defaults(tcp.main, monkeypatch, [])
    assert port_flags.pop("device") == "cuda"
    assert port_flags == jax_flags


def test_importing_the_module_imports_no_tensorflow():
    """TensorFlow is imported inside ``run_composed`` only (a subprocess:
    this one has imported it)."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c",
                        "import sys\n"
                        "import audio_style_transfer_tpu_torch.transfer.composed_parity\n"
                        "assert 'tensorflow' not in sys.modules\n"],
                       cwd=repo, env=dict(os.environ, PYTHONPATH=repo),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]


@pytest.mark.slow
def test_composed_toy_parity():
    """JAX's test_composed_toy_parity on the port, its assertions unchanged."""
    records = tcp.run_composed(epochs=8, maxiter=100, seeds=2, toy=True, device="cpu")
    assert len(records) == 2
    for r in records:
        # One-sided: our final iterate may not land more than 1% WORSE
        # than the composed reference's, judged on a single fixed loss
        # surface: the reference's TF metric (cross_rel) and our metric
        # (ours_cross_rel).  Landing lower (ours found a better basin of
        # the SAME function) is a pass: the north star is "matches or
        # beats", and on a nonconvex landscape two correct optimizers
        # need not share a minimum.
        assert r["cross_rel"] <= TOL, r
        assert r["ours_cross_rel"] <= TOL, r
        # The cross-evaluation must be self-consistent: evaluating our
        # final iterate under TF reproduces our final loss (same math).
        assert abs(r["tf_at_ours"] - r["ours"]) <= 5e-3 * abs(r["ours"]), r
