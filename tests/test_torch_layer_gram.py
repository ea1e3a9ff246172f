"""The per-layer (Gatys) gram ``ops/gram.py::layer_gram``: K8f / K8b on CUDA
tensors, the plain float32 matmul (``layer_gram_reference``) on CPU tensors.

On the CPU: the helper against the benchmark reference's einsum, the halo
path's partial grams through the same helper summing to the whole clip's,
the kernels' launch geometry, their names against what the benchmark's
trace readers match, and the port's Gatys full-stack loss and waveform
gradient (every tap a style tap, content tap 25) against the plain float32
reference of ``portbench/reference/transfer.py`` on seeded weights at full
width. On the card (marker ``cuda``; skips without one): K8f and K8b against
the plain float32 route at the 15 s clip's 237568 rows and L = 30 in both
dtypes, the autograd wiring and its launches, and the exact scan's Gatys
gradient against one window.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_style_transfer_tpu_torch.ops import _build, gram
from audio_style_transfer_tpu_torch.parallel import halo
from audio_style_transfer_tpu_torch.transfer.losses import LossSpec, gram_sums_of

ROOT = Path(__file__).resolve().parents[1]
GATYS_CONFIG = ROOT / "portbench/configs/nsynth-encoder-transfer-gatys-bf16.json"
FULL_ROWS = 237568  # the 15 s clip of the benchmark's exact15s mix, one window


def _rel(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


def _taps(nl, t, dtype, device="cpu", seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn((1, t, 128), generator=gen, device=device).to(dtype) for _ in range(nl)]


# -- CPU ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_gram_on_the_cpu_is_the_references_einsum(dtype):
    taps = _taps(5, 300, dtype, seed=1)
    got = gram.layer_gram(*taps)
    stacked = torch.cat(taps).to(torch.float32)  # [L, T, C]
    want = torch.einsum("lta,ltb->lab", stacked, stacked)
    assert got.dtype == torch.float32 and got.shape == (5, 128, 128)
    assert _rel(got, want) <= 1e-6
    assert torch.equal(got, gram.layer_gram_reference(*taps))


def test_the_halo_paths_partial_grams_sum_to_the_whole_clips():
    spec = LossSpec(gatys=True, style_layer_ids=(0, 2, 3), cont_lyr_ids=(3,))
    taps = _taps(4, 1024, torch.float32, seed=2)
    whole = gram_sums_of({i: tp for i, tp in enumerate(taps)}, spec)
    parts = [gram_sums_of({i: tp[:, a:a + 256] for i, tp in enumerate(taps)}, spec)
             for a in range(0, 1024, 256)]
    assert whole.shape == (3, 128, 128)
    assert _rel(sum(parts), whole) <= 1e-6
    assert torch.equal(whole, gram.layer_gram(*[taps[i] for i in (0, 2, 3)]))


@pytest.mark.parametrize("t,nl,sms", [(FULL_ROWS, 30, 132), (FULL_ROWS, 10, 132), (16384, 30, 132),
                                      (4096, 30, 132), (1000, 3, 132), (100, 1, 8),
                                      (958464, 30, 132), (FULL_ROWS, 32, 114)])
def test_the_launch_geometry_covers_the_rows_in_one_wave(t, nl, sms):
    rows = gram.layer_fwd_chunk_rows(t, nl, sms)
    chunks = -(-t // rows)
    assert rows % gram.LAYER_ROWS == 0 and rows >= gram.MIN_ROWS
    assert chunks * rows >= t and (chunks - 1) * rows < t
    assert chunks * nl <= max(sms * gram.LAYER_FWD_RESIDENT, nl)
    per = gram.layer_bwd_pairs_per_block(t, nl, sms)
    pairs = nl * -(-t // gram.LAYER_TILE)
    blocks = -(-pairs // per)
    assert 1 <= blocks <= sms * gram.LAYER_BWD_RESIDENT and blocks * per >= pairs


def test_the_full_stack_geometry_at_the_15_s_clip():
    # 8 chunks of 29696 rows a tap: 240 blocks of K8f in the 264 slots of 132
    # SMs; K8b's 30 x 1856 (tap, tile) pairs over 132 blocks.
    assert gram.layer_fwd_chunk_rows(FULL_ROWS, 30, 132) == 29696
    assert gram.layer_bwd_pairs_per_block(FULL_ROWS, 30, 132) == 422


def _kernel_names(source: str) -> list[str]:
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", source)


def test_the_layer_gram_kernels_are_named_for_the_trace_readers():
    from portbench.trace import KERNELS, is_own

    names = _kernel_names((ROOT / "audio_style_transfer_tpu_torch/csrc/gram.cu").read_text())
    layer = [n for n in names if n.startswith("gram_layer_")]
    assert sorted(layer) == ["gram_layer_bwd_fma_kernel", "gram_layer_bwd_kernel",
                             "gram_layer_fwd_fma_kernel", "gram_layer_fwd_kernel",
                             "gram_layer_sum_kernel"]
    k5k6 = [f for key in ("K5", "K5reduce", "K6") for f in KERNELS[key]]
    for name in layer:
        assert is_own(name), name
        assert not any(f in name for f in k5k6 + ["gram_fwd", "gram_bwd", "gram_reduce"]), name
    # The K5 / K6 readers still find their own kernels.
    assert {"gram_fwd_kernel", "gram_reduce_kernel", "gram_bwd_kernel"} <= set(names)


def test_layer_gram_refuses_what_the_kernels_do_not_take_before_any_launch():
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        gram.layer_gram_fwd(*_taps(2, 64, torch.float32))
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        gram.layer_gram_bwd(_taps(2, 64, torch.float32), torch.zeros(2, 128, 128))


@pytest.fixture(scope="module")
def gatys_problem():
    """The benchmark's Gatys configuration in float32 at full width on seeded
    weights, T = 2048, with the reference's targets."""
    from portbench.reference.transfer import Loss, style_taps
    from portbench.traffic_gen import arpeggio, drone, rng_for
    from portbench.weights import make_params

    cfg = dict(json.loads(GATYS_CONFIG.read_text()), compute_dtype="float32")
    assert cfg["gatys"] and cfg["stack"] is None and cfg["cont_lyr_ids"] == [25]
    assert style_taps(cfg) == tuple(range(30))
    params = make_params(cfg, 2**33 + 5, "cpu", encoder_only=True)
    rng = rng_for(21)
    content, style = arpeggio(rng, 2048), drone(rng, 4096)
    ref = Loss(params, cfg)
    phi_c, target = ref.targets(content, style, 2048)
    return cfg, params, ref, phi_c, target


def test_the_gatys_full_stack_loss_and_gradient_match_the_reference(gatys_problem):
    from portbench.common import model_config

    from audio_style_transfer_tpu_torch.transfer.losses import transfer_loss

    cfg, params, ref, phi_c, target = gatys_problem
    spec = LossSpec(cont_lyr_ids=(25,), style_layer_ids=tuple(range(30)), gatys=True,
                    lambd=cfg["lambd"])
    x = torch.as_tensor(np.random.RandomState(0).uniform(-120, 120, 2048), dtype=torch.float32)
    xr = x.clone().requires_grad_(True)
    want = ref(xr, phi_c, target)
    (g_want,) = torch.autograd.grad(want[0], xr)
    xp = x.clone().requires_grad_(True)
    got, parts = transfer_loss(params, xp[None], phi_c, target, model_config(cfg), spec)
    (g_got,) = torch.autograd.grad(got, xp)
    # float32 sums in other orders (the port's trunk, the reference's convs).
    torch.testing.assert_close(got, want[0], rtol=1e-5, atol=0)
    torch.testing.assert_close(parts["style_loss"], want[2], rtol=1e-5, atol=0)
    assert float(want[2].detach()) > 0 and float(g_want.norm()) > 0
    assert _rel(g_got, g_want) <= 1e-4


# -- the card ----------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k8f_holds_the_float64_gram_at_the_15_s_clip(dev, dtype):
    """K8f against the gram in float64 at 237568 rows, L = 30: within 1e-5,
    closer than the plain route (one float32 product over all the rows,
    about 1e-4 off on an H100) and far closer than a bf16-output product
    (about 2e-3, the lower precision). Two launches equal bit for bit."""
    taps = _taps(30, FULL_ROWS, dtype, dev, seed=3)
    got = gram.layer_gram_fwd(*taps)
    again = gram.layer_gram_fwd(*taps)
    plain = gram.layer_gram_reference(*taps)
    exact = torch.stack([tp[0].double().T @ tp[0].double() for tp in taps])
    torch.cuda.synchronize()
    assert torch.equal(got, again)  # fixed order: no atomics
    assert _rel(got, exact) <= 1e-5
    assert _rel(got, exact) < _rel(plain, exact)
    if dtype == torch.bfloat16:
        stl = torch.cat(taps).transpose(1, 2)
        lowp = torch.matmul(stl, stl.transpose(1, 2))  # bf16 out
        assert lowp.dtype == torch.bfloat16 and _rel(lowp.float(), exact) > 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bf16_valued", [True, False])
def test_k8b_matches_the_float32_route_at_the_15_s_clip(dev, dtype, bf16_valued):
    """K8b against autograd of the plain route at 237568 rows, L = 30, for a
    bf16-valued gradient (the engine's loss casts the gram to bf16) and a
    float32 one (the exact paths): either way the hi / lo bf16 split of
    dG + dG^T. bf16 cotangents round nearly the same float32 sums once."""
    taps = _taps(30, FULL_ROWS, dtype, dev, seed=4)
    gen = torch.Generator(device=dev).manual_seed(5)
    g = torch.randn((30, 128, 128), generator=gen, device=dev) * 1e-3
    if bf16_valued:
        g = g.to(torch.bfloat16).float()
    got = gram.layer_gram_bwd(taps, g)
    leaves = [tp.detach().requires_grad_(True) for tp in taps]
    want = torch.autograd.grad(gram.layer_gram_reference(*leaves), leaves, g)
    torch.cuda.synchronize()
    tol = 1e-3 if dtype == torch.bfloat16 else 1e-5
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert _rel(a.float(), b.float()) <= tol


@pytest.mark.cuda
def test_layer_gram_autograd_launches_the_kernels_and_no_copy(dev):
    """A Gatys ``style_gram`` of bf16 taps: K8f with its sum and K8b, no
    concatenation of the taps, no float32 copy of them, no library product."""
    from torch.profiler import ProfilerActivity, profile

    from audio_style_transfer_tpu_torch.transfer.grams import style_gram
    from portbench.trace import is_product

    taps = [tp.requires_grad_(True) for tp in _taps(30, 16384, torch.bfloat16, dev, seed=6)]
    extracts = dict(enumerate(taps))
    style_gram(extracts, tuple(range(30)), gatys=True).sum().backward()  # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        s = style_gram(extracts, tuple(range(30)), gatys=True)
        (s * s).sum().backward()
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    assert {_build.LAUNCHES["K8f"], _build.LAUNCHES["K8b"]} == {1}
    for frag in ("gram_layer_fwd_kernel", "gram_layer_sum_kernel", "gram_layer_bwd_kernel"):
        assert any(frag in n for n in names), names
    assert not any(is_product(n) or "Cat" in n for n in names), names
    # The taps' new cotangents (half a float32 copy) and scratch; the plain
    # route would hold a float32 copy of the taps besides.
    f32_copy = 30 * 16384 * 128 * 4
    assert torch.cuda.max_memory_allocated() - base < 0.75 * f32_copy


@pytest.mark.cuda
def test_the_exact_scan_gatys_gradient_matches_one_window_on_the_card(dev):
    """The Gatys exact loss at full width, 12 layers (all style taps, content
    tap 11), float32: the scan's partial grams through K8f summed over its
    windows and its gradient through K8b, against the single window."""
    from audio_style_transfer_tpu_torch.models.wavenet_ae import WaveNetAEConfig, init_params

    cfg = WaveNetAEConfig(ae_num_layers=12)
    spec = LossSpec(cont_lyr_ids=(11,), style_layer_ids=tuple(range(12)), gatys=True)
    params = {k: {m: v.to(dev) for m, v in e.items()} for k, e in init_params(0, cfg).items()
              if k.startswith("ae_")}
    t_total = 8192
    rng = np.random.RandomState(7)
    x = torch.tensor(rng.uniform(-100, 100, (1, t_total)), dtype=torch.float32, device=dev)
    phi_c = torch.tensor(rng.randn(t_total, 128), dtype=torch.float32, device=dev)
    phi_s = torch.tensor(rng.randn(12, 128, 128) * 1e-2, dtype=torch.float32, device=dev)
    _build.reset_launches()
    loss_s, g_s = halo.make_scan_exact_value_and_grad_fn(cfg, spec, t_total, 2048)(
        params, x, phi_c, phi_s)
    assert _build.LAUNCHES["K8f"] >= 8 and _build.LAUNCHES["K8b"] == 4
    loss_w, g_w = halo.make_scan_exact_value_and_grad_fn(cfg, spec, t_total, t_total)(
        params, x, phi_c, phi_s)
    torch.testing.assert_close(loss_s, loss_w, rtol=2e-5, atol=0)
    assert _rel(g_s, g_w) <= 1e-4


# -- the benchmark's readers of the new kernels and spans ---------------------

def _capture(with_program: bool):
    """A made-up capture, in us: two evaluations ``portbench.eval`` [100, 400)
    and [500, 800), each with ``gram.layer`` around K8f and its sum and
    ``gram.layer_bwd`` around K8b and a copy; a K8f launched outside them (the
    targets), and a trunk kernel in each evaluation."""
    from portbench.spans import EVAL_RANGE
    from portbench.trace import Trace

    spans = [(EVAL_RANGE, 100, 400), (EVAL_RANGE, 500, 800)]
    # (launch ts, duration, name, category)
    ops = [(20, 40, "gram_layer_fwd_kernel", "kernel")]
    for e0 in (100, 500):
        ops += [(e0 + 10, 5, "trunk_fwd_mma_kernel", "kernel"),
                (e0 + 30, 60, "gram_layer_fwd_kernel", "kernel"),
                (e0 + 40, 4, "gram_layer_sum_kernel", "kernel"),
                (e0 + 200, 120, "gram_layer_bwd_kernel", "kernel"),
                (e0 + 210, 6, "Memcpy DtoD", "gpu_memcpy")]
        if with_program:
            spans += [("gram.layer", e0 + 25, e0 + 45), ("gram.layer_bwd", e0 + 195, e0 + 215)]
    if not with_program:  # the parent: the plain route, no own kernels, no spans
        ops = [(o[0], o[1], "nvjet_gemm" if "gram_" in o[2] else o[2], o[3]) for o in ops]
    events = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a, "dur": b - a}
              for n, a, b in spans]
    for i, (launch, dur, name, cat) in enumerate(ops):
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                       "ts": launch, "dur": 2, "args": {"correlation": i + 1}})
        events.append({"ph": "X", "cat": cat, "name": name, "ts": launch + 5, "dur": dur,
                       "args": {"correlation": i + 1}})
    cfg = json.loads(GATYS_CONFIG.read_text())
    return Trace(events, 1e-3, units=2, context={"rows": FULL_ROWS, "config": cfg})


def test_the_layer_gram_bounds_at_the_15_s_clip():
    from portbench import counts, counts_layer_gram

    cfg = json.loads(GATYS_CONFIG.read_text())
    fwd = counts.bound_s(*counts_layer_gram.k8f(FULL_ROWS, 128, 30, "bfloat16"), "bfloat16")
    bwd = counts.bound_s(*counts_layer_gram.k8b(FULL_ROWS, 128, 30, "bfloat16"), "bfloat16")
    # Bytes bound both: 1.82 GB of taps in, and for K8b as much out.
    assert fwd == pytest.approx(30 * FULL_ROWS * 128 * 2 / 3.35e12, rel=2e-3)
    assert bwd == pytest.approx(2 * fwd, rel=1e-3)
    assert 0.54e-3 < fwd < 0.55e-3 and 1.08e-3 < bwd < 1.10e-3
    assert counts_layer_gram.layer_gram_eval_bound_s(FULL_ROWS, cfg, 3, 2) == pytest.approx(
        3 * fwd + 2 * bwd)


def test_the_layer_gram_readers_read_the_evaluations_and_nothing_of_a_parent():
    from portbench import counts_layer_gram, spec

    roofline = spec.metric_reader("layer_gram_roofline.transfer")
    ms = spec.metric_reader("layer_gram_ms.transfer")
    t = _capture(with_program=True)
    bound = counts_layer_gram.layer_gram_eval_bound_s(FULL_ROWS, t.context["config"], 2, 2)
    # The targets' K8f is left out: 2 x (60 + 4 + 120) us in the evaluations.
    assert roofline(t) == pytest.approx(100.0 * bound / (2 * 184e-6))
    # Inside the spans: K8f, its sum, K8b and the copy, per evaluation.
    assert ms(t) == pytest.approx((60 + 4 + 120 + 6) * 1e-3)
    parent = _capture(with_program=False)
    assert roofline(parent) is None and ms(parent) is None
