"""The channel-wise (all-pairs) gram over the whole encoder: ``ops/gram.py::
pair_gram`` at 30 taps, K5 / K6 on CUDA tensors, the plain einsum and
composition on CPU tensors, as the benchmark's ``transfer_full_exact15s``
cell runs it (no ``stack``, content tap 25).

On the CPU: the cell's configuration through ``portbench.spec``; the port's
full-stack channel-wise loss and waveform gradient against the plain float32
reference of ``portbench/reference/transfer.py`` on seeded weights at full
width; the kernels' launch geometry at the 15 s clip's 237568 rows; the
spans ``gram.pair`` / ``gram.pair_bwd`` around autograd's forward and
backward; and the benchmark's reader of those spans on a made-up capture.
On the card (marker ``cuda``; skips without one): K5 against the float64
gram at 237568 rows and 30 taps, bit for bit across two launches, in bf16
(the tensor-core kernel) and float32 (the FMA kernel), the two against each
other at 30 and 10 taps, and at a ragged clip of two clips; K6 against its
plain composition at those shapes; and autograd through ``pair_gram``
launching one K5 and one K6, each inside its span.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_style_transfer_tpu_torch.ops import _build, gram

ROOT = Path(__file__).resolve().parents[1]
CELL = "transfer_full_exact15s"
FULL_CONFIG = ROOT / "portbench/configs/nsynth-encoder-transfer-full-bf16.json"
FULL_ROWS = 237568  # the 15 s clip of the benchmark's exact15s mix, one window
H100_SMS = 132


def _rel(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


def _taps(nl, t, dtype, device="cpu", seed=0, b=1):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn((b, t, 128), generator=gen, device=device).to(dtype) for _ in range(nl)]


# -- the cell's configuration ---------------------------------------------------

def test_the_cell_resolves_to_thirty_style_taps_and_content_tap_25():
    from portbench import spec
    from portbench.reference.transfer import statistic_shape, style_taps

    cell = spec.resolve(spec.load_benchmark(ROOT), CELL, ROOT)
    cfg = cell.config
    assert cell.chips == 1 and cell.traffic["kind"] == "transfer_exact"
    assert cfg["stack"] is None and not cfg.get("gatys") and cfg["cont_lyr_ids"] == [25]
    assert style_taps(cfg) == tuple(range(30))
    assert statistic_shape(cfg) == (128, 30, 30)
    metrics = {m["name"] for m in cell.per_layer}
    assert {"pair_gram_ms.transfer", "gram_roofline.transfer"} <= metrics
    assert not any(m.startswith("layer_gram_") for m in metrics)
    assert [m["name"] for m in cell.end_to_end] == ["transfer_evals_per_s", "setup_s"]
    assert set(cell.limits) == set(cell.kind.READINGS)  # every reading judged
    # The s0 file but for the style and content taps.
    s0 = json.loads((ROOT / "portbench/configs/nsynth-encoder-transfer-s0-bf16.json").read_text())
    assert {k: v for k, v in cfg.items() if s0.get(k) != v} == {
        "about": cfg["about"], "stack": None, "cont_lyr_ids": [25]}


def test_the_engine_of_the_cell_takes_every_tap_as_a_style_tap():
    from portbench.common import model_config

    from audio_style_transfer_tpu_torch.transfer.engine import StyleTransfer, TransferSpec

    cfg = json.loads(FULL_CONFIG.read_text())
    spec = TransferSpec(stack=cfg["stack"], gatys=cfg.get("gatys", False),
                        cont_lyr_ids=tuple(cfg["cont_lyr_ids"]), device="cpu")
    engine = StyleTransfer(spec, {}, model_config(cfg))
    assert engine.loss_spec.style_layer_ids == tuple(range(30))
    assert engine.loss_spec.cont_lyr_ids == (25,) and not engine.loss_spec.gatys


# -- the loss against the plain reference ----------------------------------------

@pytest.fixture(scope="module")
def full_problem():
    """The cell's configuration in float32 at full width on seeded weights,
    T = 4096, with the reference's targets. Content and style are one window
    each, so ``Loss.targets`` reduces to two passes: the content's own
    statistic is its source statistic, and the target is the style's."""
    from portbench.reference.transfer import Loss, l2_normalize
    from portbench.traffic_gen import arpeggio, drone, rng_for
    from portbench.weights import make_params

    cfg = dict(json.loads(FULL_CONFIG.read_text()), compute_dtype="float32")
    params = make_params(cfg, 2**33 + 25, "cpu", encoder_only=True)
    rng = rng_for(25)
    content, style = arpeggio(rng, 4096), drone(rng, 4096)
    ref = Loss(params, cfg)
    phi_c, gram = ref.features(ref._quantized(content))
    phi_t = ref.features(ref._quantized(style))[1]
    return cfg, params, ref, phi_c, l2_normalize(gram + phi_t - gram)


def test_the_channel_wise_full_stack_loss_and_gradient_match_the_reference(full_problem):
    from portbench.common import model_config

    from audio_style_transfer_tpu_torch.transfer.losses import LossSpec, transfer_loss

    cfg, params, ref, phi_c, target = full_problem
    spec = LossSpec(cont_lyr_ids=(25,), style_layer_ids=tuple(range(30)), lambd=cfg["lambd"],
                    cnt_channels=cfg["cnt_channels"], nb_channels=cfg["nb_channels"])
    x = torch.as_tensor(np.random.RandomState(4).uniform(-120, 120, 4096), dtype=torch.float32)
    xr = x.clone().requires_grad_(True)
    want = ref(xr, phi_c, target)
    (g_want,) = torch.autograd.grad(want[0], xr)
    xp = x.clone().requires_grad_(True)
    got, parts = transfer_loss(params, xp[None], phi_c, target, model_config(cfg), spec)
    (g_got,) = torch.autograd.grad(got, xp)
    # The loss: float32 sums in other orders (the port's trunk and grams,
    # the reference's convs and einsum), a few ulps of the value.
    torch.testing.assert_close(got, want[0], rtol=1e-5, atol=0)
    torch.testing.assert_close(parts["style_loss"], want[2], rtol=1e-5, atol=0)
    assert float(want[2].detach()) > 0 and float(g_want.norm()) > 0
    # The gradient: that rounding carried back through 30 layers, their ReLUs
    # and the 30 x 30 pairs of 128 grams; on this problem the two orders part
    # by 5.2e-4 of its norm at this waveform and 1.1e-6 at another (seed 5),
    # so the bound leaves about 4x room above the larger.
    assert _rel(g_got, g_want) <= 2e-3


# -- the launch geometry at the 15 s clip ----------------------------------------

# float32 taps run the FMA kernels (K5: 8-channel blocks in chunks; K6: 16
# channels, blocks resident by tap bucket); bf16 taps the tensor-core kernels
# (64-channel groups, one block an SM; K6 splits a group between two blocks
# above 16 taps).
@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
@pytest.mark.parametrize("nl,sms", [(30, H100_SMS), (10, H100_SMS), (30, 114), (32, H100_SMS),
                                    (25, H100_SMS)])
def test_the_pair_gram_geometry_covers_the_clip_in_one_wave(nl, sms, bf16):
    if bf16:
        rows = gram.mma_rows(1, FULL_ROWS, 128, nl, sms, False)
        groups = 128 // gram.MMA_CHANNEL_GROUP
        assert rows % gram.MMA_ROWS == 0 and rows >= gram.MIN_ROWS
    else:
        rows = gram.fwd_chunk_rows(1, FULL_ROWS, 128, sms)
        groups = 128 // gram.CHANNEL_BLOCK
    chunks = -(-FULL_ROWS // rows)
    assert chunks * rows >= FULL_ROWS and (chunks - 1) * rows < FULL_ROWS
    assert chunks * groups <= sms
    assert gram.fwd_scratch_shape(1, FULL_ROWS, 128, nl, rows) == (1, chunks, nl * (nl + 1) // 2,
                                                                   128)
    if bf16:
        bwd = gram.mma_rows(1, FULL_ROWS, 128, nl, sms, True)
        blocks = -(-FULL_ROWS // bwd) * groups * gram.mma_split(nl, True)
        assert bwd % gram.MMA_ROWS == 0 and blocks <= sms
    else:
        bwd = gram.bwd_block_rows(1, FULL_ROWS, 128, nl, sms)
        blocks = -(-FULL_ROWS // bwd) * (128 // gram.BWD_CHANNEL_BLOCK)
        assert bwd % gram.BWD_STEP == 0 and bwd >= gram.MIN_ROWS
        assert blocks <= sms * gram.BWD_RESIDENT[gram.tap_bucket(nl)]


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
def test_the_full_stack_geometry_at_the_15_s_clip(bf16):
    if bf16:
        # Two 64-channel groups. K5: 66 chunks of 3616 rows, one block an SM
        # of 132. K6 at 30 taps: each group split between two blocks, 33 runs
        # of 7200 rows; at 10 taps (the s0 cell) unsplit, 66 runs of 3616.
        assert gram.mma_split(30, False) == 1 and gram.mma_split(30, True) == 2
        assert gram.mma_split(10, True) == 1
        assert gram.mma_rows(1, FULL_ROWS, 128, 30, H100_SMS, False) == 3616
        assert -(-FULL_ROWS // 3616) * 2 == H100_SMS
        assert gram.mma_rows(1, FULL_ROWS, 128, 30, H100_SMS, True) == 7200
        assert -(-FULL_ROWS // 7200) * 2 * 2 == H100_SMS
        assert gram.mma_rows(1, FULL_ROWS, 128, 10, H100_SMS, True) == 3616
        return
    # Bucket 32: K5's 10 triangle tiles, K6 two blocks an SM. K5: 8 chunks of
    # 29696 rows x 16 channel groups, one block an SM of 132. K6: 7200 rows a
    # block, 33 x 8 channel groups = 264 blocks, the 2 x 132 resident slots.
    assert gram.tap_bucket(30) == 32 and gram.BWD_RESIDENT[32] == 2
    assert gram.fwd_chunk_rows(1, FULL_ROWS, 128, H100_SMS) == 29696
    assert -(-FULL_ROWS // 29696) == 8
    assert gram.bwd_block_rows(1, FULL_ROWS, 128, 30, H100_SMS) == 7200
    assert -(-FULL_ROWS // 7200) * 8 == 2 * H100_SMS
    # At 10 taps (the s0 cell): bucket 16, four K6 blocks an SM.
    assert gram.tap_bucket(10) == 16
    assert -(-FULL_ROWS // gram.bwd_block_rows(1, FULL_ROWS, 128, 10, H100_SMS)) * 8 <= 4 * H100_SMS


# -- the spans -----------------------------------------------------------------

def _profile_pair_gram(taps):
    from torch.profiler import ProfilerActivity, profile

    leaves = [tp.detach().requires_grad_(True) for tp in taps]
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if taps[0].is_cuda else [])
    with profile(activities=acts) as prof:
        g = gram.pair_gram(*leaves)
        (g * g).sum().backward()
        if taps[0].is_cuda:
            torch.cuda.synchronize()
    return prof, leaves


def test_autograd_runs_the_pair_gram_inside_its_spans_on_the_cpu():
    prof, leaves = _profile_pair_gram(_taps(3, 64, torch.float32, seed=11))
    events = prof.events()
    spans = {n: [e for e in events if e.name == n] for n in ("gram.pair", "gram.pair_bwd")}
    assert len(spans["gram.pair"]) == 1 and len(spans["gram.pair_bwd"]) == 1
    fwd, bwd = spans["gram.pair"][0], spans["gram.pair_bwd"][0]
    assert fwd.time_range.end <= bwd.time_range.start
    # The plain forward's einsum inside the forward's span; h = g + g^T and
    # the plain composition inside the backward's.
    inside = lambda e, s: (s.time_range.start <= e.time_range.start  # noqa: E731
                           and e.time_range.end <= s.time_range.end)
    assert any(e.name == "aten::einsum" and inside(e, fwd) for e in events)
    assert any(e.name == "aten::transpose" and inside(e, bwd) for e in events)
    assert all(lf.grad is not None for lf in leaves)


def _capture(with_program: bool):
    """A made-up capture, in us: two evaluations ``portbench.eval`` [100, 400)
    and [500, 800), each with ``gram.pair`` around K5 and its reduce and
    ``gram.pair_bwd`` around the h add and K6; a K5 launched outside them (the
    targets), and a trunk kernel in each evaluation. The parent has the same
    kernels and no gram spans."""
    from portbench.spans import EVAL_RANGE
    from portbench.trace import Trace

    spans = [(EVAL_RANGE, 100, 400), (EVAL_RANGE, 500, 800)]
    # (launch ts, duration, name, category)
    ops = [(20, 40, "gram_fwd_kernel", "kernel")]
    for e0 in (100, 500):
        ops += [(e0 + 10, 5, "trunk_fwd_mma_kernel", "kernel"),
                (e0 + 30, 60, "gram_fwd_kernel", "kernel"),
                (e0 + 40, 4, "gram_reduce_kernel", "kernel"),
                (e0 + 200, 3, "vectorized_elementwise_kernel", "kernel"),
                (e0 + 205, 120, "gram_bwd_kernel", "kernel"),
                (e0 + 250, 7, "trunk_bwd_dy_mma_kernel", "kernel")]
        if with_program:
            spans += [("gram.pair", e0 + 25, e0 + 45), ("gram.pair_bwd", e0 + 195, e0 + 215)]
    events = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a, "dur": b - a}
              for n, a, b in spans]
    for i, (launch, dur, name, cat) in enumerate(ops):
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                       "ts": launch, "dur": 2, "args": {"correlation": i + 1}})
        events.append({"ph": "X", "cat": cat, "name": name, "ts": launch + 5, "dur": dur,
                       "args": {"correlation": i + 1}})
    cfg = json.loads(FULL_CONFIG.read_text())
    return Trace(events, 1e-3, units=2, context={"rows": FULL_ROWS, "config": cfg})


def test_the_pair_gram_reader_reads_the_spans_in_the_evaluations_and_nothing_of_a_parent():
    from portbench import spec

    ms = spec.metric_reader("pair_gram_ms.transfer")
    # Inside the spans and the evaluations: K5, its reduce, the h add and K6;
    # not the targets' K5, not the trunk kernels. Per evaluation.
    assert ms(_capture(with_program=True)) == pytest.approx((60 + 4 + 3 + 120) * 1e-3)
    assert ms(_capture(with_program=False)) is None


def test_the_gram_roofline_counts_thirty_taps_in_the_full_stack_cell():
    from portbench import counts, spec

    roofline = spec.metric_reader("gram_roofline.transfer")
    dt = "bfloat16"
    k5 = counts.bound_s(*counts.k5(FULL_ROWS, 128, 30, dt), dt)
    k6 = counts.bound_s(*counts.k6(FULL_ROWS, 128, 30, dt), dt)
    # Bytes bound both: 1.82 GB of taps in; K6 as much out besides.
    assert 0.54e-3 < k5 < 0.55e-3 and 1.08e-3 < k6 < 1.10e-3
    for with_program in (True, False):  # the reader needs no span
        got = roofline(_capture(with_program))
        assert got == pytest.approx(100.0 * 2 * (k5 + k6) / (2 * (60 + 4 + 120) * 1e-6))


# -- the card ----------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _float64_gram(taps) -> torch.Tensor:
    """[B, L, L, C] in float64, 16 channels at a time."""
    parts = []
    for c0 in range(0, 128, 16):
        e = torch.stack([tp[:, :, c0:c0 + 16].double() for tp in taps], dim=1)  # [B, L, T, 16]
        parts.append(torch.einsum("natc,nbtc->nabc", e, e))
    return torch.cat(parts, dim=3)


# (taps' dtype, taps, rows, clips): bf16 runs the tensor-core K5, float32 the
# FMA K5; "cross" holds the bf16 K5 of bf16 taps against the float32 K5 of the
# same taps cast to float32, at the full stack and at stack 0's 10 taps; the
# ragged case ends the clip 8 rows into a stage, with two clips.
K5_CASES = [pytest.param(torch.bfloat16, 30, FULL_ROWS, 1, id="bf16"),
            pytest.param(torch.float32, 30, FULL_ROWS, 1, id="float32"),
            pytest.param("cross", 30, FULL_ROWS, 1, id="cross-L30"),
            pytest.param("cross", 10, FULL_ROWS, 1, id="cross-L10"),
            pytest.param(torch.bfloat16, 30, FULL_ROWS + 8, 2, id="bf16-ragged-B2")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,nl,t,b", K5_CASES)
def test_k5_holds_the_float64_gram_at_the_15_s_clip_and_30_taps(dev, dtype, nl, t, b):
    """K5 at 237568 rows: within 1e-5 of the float64 gram, and two launches
    equal bit for bit (no atomics). bf16 (tensor cores): each 8-row stage's
    products added into a float32 sum, 1.3e-7 on an H100; float32 (FMA): a
    thread adds its 3712 rows of a chunk in ascending order, rounding each
    step, 3.7e-6. The two routes on the same bf16 values agree within 2e-5."""
    taps = _taps(nl, t, torch.bfloat16 if dtype == "cross" else dtype, dev, seed=13, b=b)
    routes = [taps, [tp.float() for tp in taps]] if dtype == "cross" else [taps]
    exact = _float64_gram(taps)
    grams = []
    for tt in routes:
        got = gram.pair_gram_fwd(*tt)
        again = gram.pair_gram_fwd(*tt)
        torch.cuda.synchronize()
        assert got.shape == (b, nl, nl, 128) and got.dtype == torch.float32
        assert torch.equal(got, again)
        assert torch.equal(got, got.transpose(1, 2))  # the reduce mirrors the triangle
        assert _rel(got, exact) <= 1e-5
        grams.append(got)
    if dtype == "cross":
        assert _rel(grams[0], grams[1]) <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,t,b", [
    pytest.param(torch.bfloat16, FULL_ROWS, 1, id="bf16"),
    pytest.param(torch.float32, FULL_ROWS, 1, id="float32"),
    pytest.param(torch.bfloat16, FULL_ROWS + 8, 2, id="bf16-ragged-B2")])
def test_k6_matches_its_plain_composition_at_the_15_s_clip_and_30_taps(dev, dtype, t, b):
    """K6 at 237568 rows, L = 30 against the plain composition: both sum
    h[a, b] E_b in float32 and round once (bf16: h in two bf16 parts on the
    tensor cores, within 2^-18 of it); bf16 rounds the two nearly equal sums
    to within an ulp."""
    taps = _taps(30, t, dtype, dev, seed=14, b=b)
    gen = torch.Generator(device=dev).manual_seed(15)
    g = torch.randn((b, 30, 30, 128), generator=gen, device=dev) * 1e-3
    h = (g + g.transpose(1, 2)).contiguous()
    got = gram.pair_gram_bwd(taps, h)
    want = gram.pair_gram_bwd_plain(taps, h)
    torch.cuda.synchronize()
    tol = 1e-3 if dtype == torch.bfloat16 else 1e-6
    for a, w in zip(got, want):
        assert a.dtype == dtype and a.shape == w.shape
        assert _rel(a.float(), w.float()) <= tol


def _spans_probe(trace_path: str) -> None:
    """One profiled forward and backward of ``pair_gram`` over 30 bf16 taps at
    the 15 s clip, read as the benchmark's reader reads it; prints what it
    found as one JSON line. The card test below runs it in a process of its
    own: in one process with tests/test_torch_layer_gram.py's K8 tests after
    it, that file's profiled test found no K8 kernel in its capture (H100,
    torch 2.11), so this capture is kept apart from every other test's."""
    from portbench.trace import Trace

    taps = _taps(30, FULL_ROWS, torch.bfloat16, torch.device("cuda"), seed=16)
    _profile_pair_gram(taps)  # warm-up
    _build.reset_launches()
    prof, leaves = _profile_pair_gram(taps)
    prof.export_chrome_trace(trace_path)
    t = Trace(json.loads(Path(trace_path).read_text())["traceEvents"], 1.0, 1, {})
    k5, k5r, k6 = t.named("K5"), t.named("K5reduce"), t.named("K6")
    print(json.dumps({
        "launches": [_build.LAUNCHES["K5"], _build.LAUNCHES["K6"]],
        "kernels": [len(k5), len(k5r), len(k6)],
        "in_gram.pair": len(t.launched_in("gram.pair", k5 + k5r)),
        "in_gram.pair_bwd": len(t.launched_in("gram.pair_bwd", k6)),
        "crossed": len(t.launched_in("gram.pair", k6) + t.launched_in("gram.pair_bwd", k5)),
        "bf16_grads": all(lf.grad is not None and lf.grad.dtype == torch.bfloat16
                          for lf in leaves)}))


@pytest.mark.cuda
def test_pair_gram_autograd_launches_one_k5_and_one_k6_inside_the_spans(dev, tmp_path):
    """``pair_gram`` of 30 bf16 taps at the 15 s clip forward and backward:
    one K5 (with its reduce) inside ``gram.pair``, one K6 inside
    ``gram.pair_bwd``, as the benchmark's reader finds them."""
    run = ("import importlib.util, sys; s = importlib.util.spec_from_file_location('probe', "
           "sys.argv[1]); m = importlib.util.module_from_spec(s); s.loader.exec_module(m); "
           "m._spans_probe(sys.argv[2])")
    out = subprocess.run([sys.executable, "-c", run, __file__, str(tmp_path / "trace.json")],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {
        "launches": [1, 1], "kernels": [1, 1, 1], "in_gram.pair": 2, "in_gram.pair_bwd": 1,
        "crossed": 0, "bf16_grads": True}
