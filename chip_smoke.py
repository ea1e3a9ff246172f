"""Drive the PyTorch/CUDA port once on one GPU and check it.

Run from the root of the repository:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the hand-written kernels (audio_style_transfer_tpu_torch/csrc),
     one nvcc per source, side by side;
  3. hold each kernel against its plain PyTorch version at full width
     (T=16384, C=128, the 30 trunk layers), in float32 with TF32 off and in
     bfloat16, and time both (CUDA events, median of runs): K1/K2 and
     K7f/K7b layer by layer on the plain chain's own inputs (K1/K2 are the
     tensor-core kernels in bfloat16 and the FMA kernels in float32; the
     FMA kernels are also held against them and timed beside them, and the
     bfloat16 K2 is timed per phase), K2-wf on each group of the wavefront
     plan (bit for bit against the FMA K2 launches it is built on, and
     against the K2 launches it replaces), K5 and K6 on the stack-0 taps
     {0..9} (L=10) and on all 30 taps (L=30), and on two clips of a ragged
     T, K5 twice on the same inputs for equal bits, both timed as a
     replayed CUDA graph with one torch.einsum beside each as a yardstick;
     K1 and K2 once more with a valid window whose edges cut 128-row tiles
     (the exact long-form scan's edge windows), against their windowed plain
     versions and timed beside the unwindowed kernels; then K1, K2, K5 and
     K6 against their plain versions at the shapes the exact long-form runs
     give them (the scan's 40960-row window with its two edge windows and
     with none, its cropped 32768-row gram, the single window's 237568 rows);
     then a bare bfloat16 loss+gradient evaluation at stack 0 and at the
     full stack, CUDA events beside the host clock, with the kernel
     launches of one evaluation;
  4. one float32 loss + waveform gradient on the card against the plain
     versions on the CPU, for stack 0 and for the full stack (style taps
     0..29, content tap 25); the STFT L1 regularizer's value and gradient
     card against CPU; one More-Thuente line search on the card on the
     stack-0 loss with the regularizer (Wolfe conditions at the step taken);
     the exact long-form loss and waveform gradient at the 1e-6 start in its
     two flavours (one window over the clip; a scan over 8 halo-extended
     windows with the pad masked) against each other, float32 and bfloat16;
  5. drive the main paths, each with the launch counts set to 0 just before
     and read just after, checking that it launched exactly its kernels:
     the port's transfer CLI on two synthetic clips (bf16, random weights,
     3 epochs) at stack 0 and at the full stack with --cont_lyrs 25 {K1,
     K2, K5, K6}, one bf16 engine epoch of the per-layer flavour at the full
     stack {K7f, K7b, K5, K6}, then the chunked long-form CLI (4 windows,
     --longform --ot_components 8 --gamma 1e-3 --stack 0, 2 epochs) with the
     wavefront backward on {K1, K2, K2wf, K5, K6; K2wf = 3 and K2 = 18 per
     evaluation} and once more with it off; in every run K6 is launched once
     per evaluation that took a gradient, and K5 at least as often; the
     stack-0 and full-stack CLI runs again in float32 (the full-stack final
     loss held to a band) and the --gatys CLI in both types {K1, K2}, with
     the bf16 / f32 ratio of final losses printed per path; then the exact
     long-form CLI (--exact, bf16, --stack 0 --gamma 1e-3) on a 15 s clip as
     one window and as a scan of 32768-sample windows, launches per
     evaluation checked, with evals/s, ms per evaluation and peak memory;
  6. print the per-kernel JSON line (time, plain time, bound, library time),
     then the result line.

It imports nothing of JAX. Numbers it prints are for the card it ran on.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import wave

import numpy as np

T, C, LAYERS = 16384, 128, 30
STYLE = tuple(range(10))
FULL = tuple(range(LAYERS))
EMIT = STYLE + (29,)
REPS = 20
# Tolerances, as max|kernel - plain| / max|plain|:
#  float32: the same float32 products summed in another order (~1e-6);
#  bfloat16: the f32 sums differ as above, and a value that lands on the
#  other side of a bf16 rounding boundary moves by one ulp (2^-8 of it).
TOL = {"float32": 2e-5, "bfloat16": 1e-2}
# Mask bytes can differ only where a value within rounding of zero changes
# sign; allowed share of differing bytes per layer.
MASK_TOL = 1e-4
KERNELS = ("K1", "K2", "K2wf", "K5", "K6", "K7f", "K7b")
# Published peaks of one H100 SXM: device memory rate, and dense operation
# rates by the type of the inputs (float32 outside the tensor cores).
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"float32": 67e12, "bfloat16": 989e12}
WINDOWS = 4  # windows of the long-form run
RAGGED_T = 1000  # rows of the gram kernels' ragged check: no multiple of their tiles
# The valid window of the windowed K1/K2 check, in rows: both edges inside a
# 128-row tile of the bf16 kernels and a 64-row tile of the f32 ones.
WINDOW = (1000, T - 1500)
# The exact long-form runs: a 15 s clip; one window trims it to a multiple of
# 4096; the scan trims to a multiple of 512 and pads to 8 windows.
EXACT_SAMPLES = 240000
SCAN_WINDOW = 32768
# The float32 full-stack CLI run (3 epochs from the 1e-6 start, these clips and
# weights) ended at 6.8539 or 6.8540 in all four kernel / plain combinations
# of the gram (NVIDIA H100 80GB HBM3). The start point is ill-conditioned
# (the first step is scaled by 1/||g||_1 and the trajectory amplifies rounding
# differences), so the band is 1% wide, not a few ulps.
F32_FULL_STACK_LOSS = 6.854
F32_BAND = 0.01


def synth_audio(seconds: float, sr: int = 16000, kind: str = "content"):
    """Deterministic synthetic audio (a copy of bench.py::synth_audio)."""
    t = np.arange(int(seconds * sr)) / sr
    if kind == "content":
        f = 220.0 * 2 ** (np.floor(t * 4) % 8 / 4.0)
        x = 0.4 * np.sin(2 * np.pi * f * t) + 0.2 * np.sin(2 * np.pi * 2 * f * t)
    else:
        x = sum(0.25 / (k + 1) * np.sin(2 * np.pi * 110 * (k + 1) * t + 0.1 * k)
                for k in range(8))
    return x.astype(np.float32)


def write_wav(path: str, x, sr: int = 16000) -> None:
    """Mono float audio in [-1, 1] as 16-bit PCM WAV."""
    pcm = (np.clip(x, -1.0, 1.0) * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def cuda_ms(fn, reps: int = REPS, warmup: int = 3, graph: bool = False) -> float:
    """Median milliseconds of fn() between two CUDA events. With ``graph``,
    fn's launches are captured once into a CUDA graph and the replay is
    timed: the device's time for them, free of the host's time to enqueue
    each (which exceeds a kernel of some 10 us)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if graph:
        captured = torch.cuda.CUDAGraph()
        with torch.cuda.graph(captured):
            fn()
        fn = captured.replay
        fn()
        torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(nbytes: float, ops: float, dtype_name: str) -> dict:
    """The least time the card could take: the bytes the function must move
    (inputs read once, outputs written once) over the memory rate, or its
    operations over the peak rate for the inputs' type, whichever is larger."""
    by_bytes = nbytes / PEAK_BYTES_S * 1e3
    by_ops = ops / PEAK_OPS_S[dtype_name] * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def rel_err(a, b) -> tuple[float, float]:
    """(max|a - b|, that over max|b|) in float32."""
    a, b = a.float(), b.float()
    abs_err = float((a - b).abs().max())
    return abs_err, abs_err / max(float(b.abs().max()), 1e-30)


def check(name: str, a, b, tol: float) -> float:
    abs_err, rel = rel_err(a, b)
    ok = rel <= tol
    print(f"  {name}: max|d| {abs_err:.3e} (rel {rel:.3e}, tol {tol:.0e}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return abs_err


def check_all(name: str, outs, wants, tol: float) -> float:
    """check() over a list of outputs, held to the largest relative error."""
    errs = [rel_err(a, b) for a, b in zip(outs, wants)]
    abs_err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
    ok = rel <= tol
    print(f"  {name}: max|d| {abs_err:.3e} (worst rel {rel:.3e} over {len(errs)} "
          f"outputs, tol {tol:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return abs_err


def chain_check(label: str, weights, x0, dtaps: dict, window, tol: float):
    """K1 and K2 over the 30 layers at x0's row count (one clip), with the
    valid window ``window`` or None, layer by layer on the plain chain's own
    inputs, masks and cotangents. Returns (K1 max|d|, K2 max|d|, the plain
    chain's first ten outputs)."""
    import torch

    from audio_style_transfer_tpu_torch.ops import chain

    wd, bd, wr, br = weights
    rows = x0.shape[0]
    dils = tuple(2 ** (k % 10) for k in range(LAYERS))
    cur, masks, inmask, outs = x0, [], None, []
    k1_err, k1_share = 0.0, 0.0
    for j, d in enumerate(dils):
        out_p, m_p, im_p = chain.layer_fwd_plain(cur, wd[j], bd[j], wr[j], br[j], d, rows,
                                                 want_inmask=(j == 0), valid_window=window)
        out_k, m_k, im_k = chain.layer_fwd(cur, wd[j], bd[j], wr[j], br[j], d, rows,
                                           want_inmask=(j == 0), valid_window=window)
        abs_err, rel = rel_err(out_k, out_p)
        share = float((m_k != m_p).float().mean())
        if j == 0:
            share = max(share, float((im_k != im_p).float().mean()))
            inmask = im_p
        masked_ok = True
        if window is not None:
            lo, hi = chain.clamp_window(window, rows)
            outside = torch.cat([out_k[:lo], out_k[hi:]])
            bits = torch.cat([m_k[:lo], m_k[hi:]]) & 1
            masked_ok = not (bool(outside.any()) or bool(bits.any()))
        if rel > tol or share > MASK_TOL or not masked_ok:
            raise AssertionError(f"K1 layer {j}, {rows} rows, {label}: rel err {rel:.3e}, "
                                 f"{share:.2e} of mask bytes differ, or a masked row is not zero")
        k1_err, k1_share = max(k1_err, abs_err), max(k1_share, share)
        cur = out_p
        masks.append(m_p)
        if j < len(STYLE):
            outs.append(out_p)
    dx, k2_err = dtaps[LAYERS - 1], 0.0
    for j in range(LAYERS - 1, -1, -1):
        dtap = dtaps.get(j) if j != LAYERS - 1 else None
        in_m = masks[j - 1] if j > 0 else inmask
        dx_p = chain.layer_bwd_plain(dx, dtap, masks[j], in_m, wd[j], wr[j], dils[j], rows, window)
        abs_err, rel = rel_err(
            chain.layer_bwd(dx, dtap, masks[j], in_m, wd[j], wr[j], dils[j], rows, window), dx_p)
        if rel > tol:
            raise AssertionError(f"K2 layer {j}, {rows} rows, {label}: rel err {rel:.3e} > {tol}")
        k2_err = max(k2_err, abs_err)
        dx = dx_p
    zeros = "" if window is None else ", masked rows zero with a zero bit 0"
    print(f"  K1 at {rows} rows, {label}: max|d| {k1_err:.3e} over 30 layers (tol rel {tol:.0e}), "
          f"mask bytes differing <= {k1_share:.2e}{zeros} ok; K2: max|d| {k2_err:.3e} ok")
    return k1_err, k2_err, outs


def exact_shapes_phase(dtype_name: str, params, dev) -> dict:
    """K1, K2, K5 and K6 against their plain versions at the shapes the exact
    long-form runs give them: the scan's halo-extended window (its two edge
    windows masked, a middle one not) and its cropped ten-tap gram, and the
    single window's whole clip. Returns the largest max|d| per kernel."""
    import torch

    from audio_style_transfer_tpu_torch.models.wavenet_ae import WaveNetAEConfig
    from audio_style_transfer_tpu_torch.ops import chain, gram
    from audio_style_transfer_tpu_torch.parallel import halo

    dt = getattr(torch, dtype_name)
    tol = TOL[dtype_name]
    wd, bd, wr, br = chain.stack_trunk_weights(params, LAYERS)
    weights = (wd.to(dev, dt).contiguous(), bd.to(dev, torch.float32).contiguous(),
               wr.to(dev, dt).contiguous(), br.to(dev, torch.float32).contiguous())
    radius = halo._window_radius(WaveNetAEConfig(), align=2048)
    w_ext = SCAN_WINDOW + 2 * radius
    scan_valid = (EXACT_SAMPLES // 512) * 512
    last = scan_valid // SCAN_WINDOW  # the window that holds the clip's end
    one_window = (EXACT_SAMPLES // 4096) * 4096
    cases = (  # rows, valid window, rows cropped each side for the gram
        (w_ext, (radius, w_ext), radius),  # the scan's first window
        (w_ext, (0, scan_valid - last * SCAN_WINDOW + radius), None),  # its last
        (w_ext, None, None),  # a middle window
        (one_window, None, 0),  # the single window
    )
    print(f"[exact shapes {dtype_name}] scan windows of {w_ext} rows (radius {radius}), one "
          f"window of {one_window} rows")
    errs = {k: 0.0 for k in ("K1", "K2", "K5", "K6")}
    gen = torch.Generator(device=dev).manual_seed(1)
    for rows, window, crop in cases:
        x0 = (torch.randn((rows, C), generator=gen, device=dev) * 0.5).to(dt)
        dtaps = {j: (torch.randn((rows, C), generator=gen, device=dev) * 1e-3).to(dt)
                 for j in EMIT}
        label = "no window" if window is None else f"the valid window {window}"
        k1, k2, outs = chain_check(label, weights, x0, dtaps, window, tol)
        errs["K1"], errs["K2"] = max(errs["K1"], k1), max(errs["K2"], k2)
        del dtaps
        if crop is None:
            continue
        taps = [o[None, crop:rows - crop] for o in outs]
        nl = len(taps)
        h = torch.randn((1, nl, nl, C), generator=gen, device=dev)
        where = f"L={nl}, T={rows - 2 * crop}"
        errs["K5"] = max(errs["K5"], check(f"K5 gram {where}", gram.pair_gram_fwd(*taps),
                                           gram.pair_gram_reference(*taps), tol))
        errs["K6"] = max(errs["K6"], check_all(f"K6 gram backward {where}",
                                               gram.pair_gram_bwd(taps, h),
                                               gram.pair_gram_bwd_plain(taps, h), tol))
        del taps, outs
    torch.cuda.empty_cache()
    return errs


def kernel_phase(dtype_name: str, params, dev) -> dict:
    """Compare K1, K2, K2-wf, K5, K6, K7f and K7b with their plain versions;
    time both; work out each kernel's bound from these shapes."""
    import torch

    from audio_style_transfer_tpu_torch.ops import chain, encoder, gram

    dt = getattr(torch, dtype_name)
    tol = TOL[dtype_name]
    dils = tuple(2 ** (k % 10) for k in range(LAYERS))
    wd, bd, wr, br = chain.stack_trunk_weights(params, LAYERS)
    wd, wr = wd.to(dev, dt).contiguous(), wr.to(dev, dt).contiguous()
    bd, br = bd.to(dev, torch.float32).contiguous(), br.to(dev, torch.float32).contiguous()
    gen = torch.Generator(device=dev).manual_seed(0)
    x0 = (torch.randn((T, C), generator=gen, device=dev) * 0.5).to(dt)
    print(f"[kernels {dtype_name}] T={T} C={C} layers={LAYERS} emit={EMIT}")

    # K1 and K7f, layer by layer on the plain chain's own inputs.
    xs, masks, kmasks, inmask = [x0], [], [], None
    k1_err, k7f_err, mask_share, k1_fma_err, k1_fma_share = 0.0, 0.0, 0.0, 0.0, 0.0
    for j, d in enumerate(dils):
        out_p, m_p, im_p = chain.layer_fwd_plain(xs[-1], wd[j], bd[j], wr[j], br[j], d, T,
                                                 want_inmask=(j == 0))
        out_k, m_k, im_k = chain.layer_fwd(xs[-1], wd[j], bd[j], wr[j], br[j], d, T,
                                           want_inmask=(j == 0))
        abs_err, rel = rel_err(out_k, out_p)
        if rel > tol:
            raise AssertionError(f"K1 layer {j}: rel err {rel:.3e} > {tol}")
        k1_err = max(k1_err, abs_err)
        # The FMA kernel in the same type: in bfloat16 the other
        # implementation of K1, held against the tensor-core one.
        out_f, m_f, _ = chain.layer_fwd_fma(xs[-1], wd[j], bd[j], wr[j], br[j], d, T)
        abs_err, rel = rel_err(out_k, out_f)
        fma_share = float((m_k != m_f).float().mean())
        if rel > tol or fma_share > MASK_TOL:
            raise AssertionError(f"K1 layer {j} against the FMA kernel: rel err {rel:.3e}, "
                                 f"{fma_share:.2e} of mask bytes differ")
        k1_fma_err, k1_fma_share = max(k1_fma_err, abs_err), max(k1_fma_share, fma_share)
        abs_err, rel = rel_err(encoder.block_fwd(xs[-1], wd[j], bd[j], wr[j], br[j], d, T),
                               out_p)
        if rel > tol:
            raise AssertionError(f"K7f layer {j}: rel err {rel:.3e} > {tol}")
        k7f_err = max(k7f_err, abs_err)
        share = float((m_k != m_p).float().mean())
        if j == 0:
            share = max(share, float((im_k != im_p).float().mean()))
            inmask = im_p
        mask_share = max(mask_share, share)
        if share > MASK_TOL:
            raise AssertionError(f"K1 layer {j}: {share:.2e} of mask bytes differ")
        xs.append(out_p)
        masks.append(m_p)
        kmasks.append(m_f)
    print(f"  K1 taps: max|d| {k1_err:.3e} over 30 layers (tol rel {tol:.0e}) ok; "
          f"mask bytes differing <= {mask_share:.2e} (tol {MASK_TOL:.0e}) ok")
    print(f"  K1 against the FMA kernel: max|d| {k1_fma_err:.3e}, mask bytes differing <= "
          f"{k1_fma_share:.2e} ok")
    print(f"  K7f out: max|d| {k7f_err:.3e} over 30 layers (tol rel {tol:.0e}) ok")

    # K2 and K7b, layer by layer on the plain chain's cotangents (and masks).
    dtaps = {j: (torch.randn((T, C), generator=gen, device=dev) * 1e-3).to(dt) for j in EMIT}
    dx = dtaps[LAYERS - 1]
    k2_err, k7b_err, k2_fma_err = 0.0, 0.0, 0.0
    gs, dxs = {}, {}
    for j in range(LAYERS - 1, -1, -1):
        dxs[j] = dx  # the cotangent of layer j's output, before its tap's
        dtap = dtaps.get(j) if j != LAYERS - 1 else None
        in_m = masks[j - 1] if j > 0 else inmask
        dx_p = chain.layer_bwd_plain(dx, dtap, masks[j], in_m, wd[j], wr[j], dils[j], T)
        dx_k = chain.layer_bwd(dx, dtap, masks[j], in_m, wd[j], wr[j], dils[j], T)
        abs_err, rel = rel_err(dx_k, dx_p)
        if rel > tol:
            raise AssertionError(f"K2 layer {j}: rel err {rel:.3e} > {tol}")
        k2_err = max(k2_err, abs_err)
        abs_err, rel = rel_err(
            dx_k, chain.layer_bwd_fma(dx, dtap, masks[j], in_m, wd[j], wr[j], dils[j], T))
        if rel > tol:
            raise AssertionError(f"K2 layer {j} against the FMA kernel: rel err {rel:.3e}")
        k2_fma_err = max(k2_fma_err, abs_err)
        gs[j] = dx if dtap is None else dx + dtap  # layer j's output cotangent
        # K7b recomputes its gate y > 0 from x with the FMA K1's
        # dilated-conv code, so its gate is bit 1 of that kernel's mask
        # (kmasks), whose flips against the plain gate are bounded above. Its
        # plain version here takes that gate: a y within rounding of zero
        # that flips would move the cotangent of its neighbourhood by about
        # its own size.
        want = chain.layer_bwd_plain(gs[j], None, kmasks[j], (xs[j] > 0).to(torch.uint8),
                                     wd[j], wr[j], dils[j], T)
        abs_err, rel = rel_err(encoder.block_bwd(xs[j], gs[j], wd[j], bd[j], wr[j], dils[j], T),
                               want)
        if rel > tol:
            raise AssertionError(f"K7b layer {j}: rel err {rel:.3e} > {tol}")
        k7b_err = max(k7b_err, abs_err)
        dx = dx_p
    print(f"  K2 dx: max|d| {k2_err:.3e} over 30 layers (tol rel {tol:.0e}) ok; against the "
          f"FMA kernel max|d| {k2_fma_err:.3e} ok")
    print(f"  K7b dx: max|d| {k7b_err:.3e} over 30 layers (tol rel {tol:.0e}; plain version "
          f"with the FMA K1's gate) ok")

    # K2-wf on every group of the wavefront plan, on the plain chain's
    # cotangents and masks: against its plain version, bit for bit against
    # the single-layer FMA K2 launches it is built on, and against the K2
    # launches it replaces (in bfloat16 the tensor-core kernels).
    groups = [g for g in chain.plan_bwd_groups(dils, T, x0.element_size())
              if g.splits is not None]
    if not groups:
        raise AssertionError("the wavefront plan holds no group at the full geometry")

    def group_args(g):
        js = range(g.j0, g.j0 + len(g.dils))
        return (dxs[js[-1]], [dtaps.get(j) if j != LAYERS - 1 else None for j in js],
                [masks[j] for j in js], masks[g.j0 - 1] if g.j0 else inmask,
                wd[g.j0:js[-1] + 1], wr[g.j0:js[-1] + 1])

    def k2_chain(g, layer):
        dxn, gtaps, gmasks, in_m, gwd, gwr = group_args(g)
        for j in range(len(g.dils) - 1, -1, -1):
            dxn = layer(dxn, gtaps[j], gmasks[j], gmasks[j - 1] if j else in_m,
                        gwd[j], gwr[j], g.dils[j], T)
        return dxn

    wf_err, wf_vs_k2 = 0.0, 0.0
    for g in groups:
        got = chain.group_bwd(*group_args(g), g, T)
        want = chain.group_bwd_plain(*group_args(g), g.dils, T, g.tile, g.splits)
        abs_err, rel = rel_err(got, want)
        if rel > tol:
            raise AssertionError(f"K2-wf group at layer {g.j0}: rel err {rel:.3e} > {tol}")
        wf_err = max(wf_err, abs_err)
        if not torch.equal(got, k2_chain(g, chain.layer_bwd_fma)):
            raise AssertionError(f"K2-wf group at layer {g.j0} differs from the FMA K2 launches")
        abs_err, rel = rel_err(got, k2_chain(g, chain.layer_bwd))
        if rel > tol:
            raise AssertionError(f"K2-wf group at layer {g.j0} against K2: rel err {rel:.3e}")
        wf_vs_k2 = max(wf_vs_k2, abs_err)
    print(f"  K2-wf dx: max|d| {wf_err:.3e} over {len(groups)} groups of dils "
          f"{groups[0].dils} at tile {groups[0].tile} (tol rel {tol:.0e}) ok; equal to the FMA "
          f"K2 launches bit for bit; against the K2 launches it replaces max|d| "
          f"{wf_vs_k2:.3e} (tol rel {tol:.0e}) ok")

    # K1 and K2 with a valid window that cuts tiles.
    k1w_err, k2w_err, _ = chain_check(f"the valid window {WINDOW}", (wd, bd, wr, br), x0, dtaps,
                                      WINDOW, tol)

    # K5 and K6 on the ten stack-0 taps and on all 30 taps; then on two
    # clips of a T that ends inside a tile (the taps' first RAGGED_T rows and
    # their last). K5 twice on the same inputs: its sums have a fixed order.
    taps = {nl: [xs[j + 1][None] for j in range(nl)] for nl in (10, 30)}
    hs = {nl: torch.randn((1, nl, nl, C), generator=gen, device=dev) for nl in (10, 30)}
    errs = {}
    for nl in (10, 30):
        ragged = [torch.stack([tp[0, :RAGGED_T], tp[0, -RAGGED_T:]]) for tp in taps[nl]]
        h2 = torch.randn((2, nl, nl, C), generator=gen, device=dev)
        for label, tp, h in ((f"L={nl}", taps[nl], hs[nl]),
                             (f"L={nl}, B=2, T={RAGGED_T}", ragged, h2)):
            got = gram.pair_gram_fwd(*tp)
            if not torch.equal(got, gram.pair_gram_fwd(*tp)):
                raise AssertionError(f"K5 gram {label}: two launches differ in their bits")
            err = check(f"K5 gram {label} (two launches equal bit for bit)", got,
                        gram.pair_gram_reference(*tp), tol)
            errs[f"K5 L={nl}"] = max(errs.get(f"K5 L={nl}", 0.0), err)
            err = check_all(f"K6 gram backward {label}", gram.pair_gram_bwd(tp, h),
                            gram.pair_gram_bwd_plain(tp, h), tol)
            errs[f"K6 L={nl}"] = max(errs.get(f"K6 L={nl}", 0.0), err)

    # Times: a whole trunk direction (30 launches) and one gram.
    def fwd(layer, window=None):
        def run():
            cur = x0
            for j, d in enumerate(dils):
                cur = layer(cur, wd[j], bd[j], wr[j], br[j], d, T, j == 0, window)[0]
        return run

    def bwd(layer, window=None):
        def run():
            cur = dtaps[LAYERS - 1]
            for j in range(LAYERS - 1, -1, -1):
                in_m = masks[j - 1] if j > 0 else inmask
                dtap = dtaps.get(j) if j != LAYERS - 1 else None
                cur = layer(cur, dtap, masks[j], in_m, wd[j], wr[j], dils[j], T, window)
        return run

    def blocks(block, backward: bool):
        def run():
            for j, d in enumerate(dils):
                if backward:
                    block(xs[j], gs[j], wd[j], bd[j], wr[j], d, T)
                else:
                    block(xs[j], wd[j], bd[j], wr[j], br[j], d, T)
        return run

    # K1, K2, K5 and K6 are timed as a replayed CUDA graph of their launches
    # (the kernels' own time) and, beside it, as eager wrapper calls (what a
    # caller that enqueues them one by one sees: the host's time per call
    # where that exceeds the kernel's).
    times = {
        "K1": (cuda_ms(fwd(chain.layer_fwd), graph=True) / LAYERS,
               cuda_ms(fwd(chain.layer_fwd_plain)) / LAYERS),
        "K2": (cuda_ms(bwd(chain.layer_bwd), graph=True) / LAYERS,
               cuda_ms(bwd(chain.layer_bwd_plain)) / LAYERS),
        "K7f": (cuda_ms(blocks(encoder.block_fwd, False)) / LAYERS,
                cuda_ms(blocks(encoder.block_fwd_plain, False)) / LAYERS),
        "K7b": (cuda_ms(blocks(encoder.block_bwd, True)) / LAYERS,
                cuda_ms(blocks(encoder.block_bwd_plain, True)) / LAYERS),
    }
    fma_ms = {"K1": cuda_ms(fwd(chain.layer_fwd_fma), graph=True) / LAYERS,
              "K2": cuda_ms(bwd(chain.layer_bwd_fma), graph=True) / LAYERS}
    eager_ms = {"K1": cuda_ms(fwd(chain.layer_fwd)) / LAYERS,
                "K2": cuda_ms(bwd(chain.layer_bwd)) / LAYERS}
    # The windowed kernels between two timings of the unwindowed ones (the
    # same launches with two more integers; the same bytes and bound).
    windowed_ms = {}
    for k, run in (("K1", fwd), ("K2", bwd)):
        layer = chain.layer_fwd if k == "K1" else chain.layer_bwd
        ms = [cuda_ms(run(layer, w), graph=True) / LAYERS for w in (None, WINDOW, WINDOW, None)]
        windowed_ms[k] = min(ms[1:3])
        print(f"  {k} with the valid window, time per launch: {ms[1]:.4f}, {ms[2]:.4f} ms between "
              f"{ms[0]:.4f} and {ms[3]:.4f} ms without a window")
    if dt == torch.bfloat16:
        # The tensor-core K2 phase by phase, on the plain chain's cotangents.
        layer_args = [(dxs[j], dtaps.get(j) if j != LAYERS - 1 else None,
                       masks[j - 1] if j > 0 else inmask) for j in range(LAYERS)]
        dys = [chain.layer_bwd_mma_phase1(dxn, dtap, masks[j], wr[j], T)
               for j, (dxn, dtap, _) in enumerate(layer_args)]
        phase1 = cuda_ms(lambda: [chain.layer_bwd_mma_phase1(dxn, dtap, masks[j], wr[j], T)
                                  for j, (dxn, dtap, _) in enumerate(layer_args)],
                         graph=True) / LAYERS
        phase2 = cuda_ms(lambda: [chain.layer_bwd_mma_phase2(dxn, dtap, dys[j], in_m, wd[j],
                                                             dils[j], T)
                                  for j, (dxn, dtap, in_m) in enumerate(layer_args)],
                         graph=True) / LAYERS
        print(f"  K2 time per launch by phase: dy {phase1:.4f} ms, dx {phase2:.4f} ms")
    ng = len(groups)
    times["K2wf"] = (
        cuda_ms(lambda: [chain.group_bwd(*group_args(g), g, T) for g in groups]) / ng,
        cuda_ms(lambda: [chain.group_bwd_plain(*group_args(g), g.dils, T, g.tile, g.splits)
                         for g in groups]) / ng)
    k2_ms = cuda_ms(lambda: [k2_chain(g, chain.layer_bwd) for g in groups], graph=True) / ng
    k2_fma_ms = cuda_ms(lambda: [k2_chain(g, chain.layer_bwd_fma) for g in groups],
                        graph=True) / ng
    print(f"  K2-wf time per group of {len(groups[0].dils)} layers: {times['K2wf'][0]:.4f} ms, "
          f"against {k2_ms:.4f} ms for the {len(groups[0].dils)} K2 launches it replaces "
          f"(layer_bwd) and {k2_fma_ms:.4f} ms for the {len(groups[0].dils)} FMA K2 launches "
          f"(layer_bwd_fma)")
    # One torch.einsum beside each gram kernel: a yardstick, used nowhere in
    # the port.
    library = {}
    for nl in (10, 30):
        times[f"K5 L={nl}"] = (cuda_ms(lambda: gram.pair_gram_fwd(*taps[nl]), graph=True),
                               cuda_ms(lambda: gram.pair_gram_reference(*taps[nl])))
        times[f"K6 L={nl}"] = (cuda_ms(lambda: gram.pair_gram_bwd(taps[nl], hs[nl]), graph=True),
                               cuda_ms(lambda: gram.pair_gram_bwd_plain(taps[nl], hs[nl])))
        eager_ms[f"K5 L={nl}"] = cuda_ms(lambda: gram.pair_gram_fwd(*taps[nl]))
        eager_ms[f"K6 L={nl}"] = cuda_ms(lambda: gram.pair_gram_bwd(taps[nl], hs[nl]))
        e = torch.cat(taps[nl])  # [L, T, C]
        h = hs[nl][0].to(dt)
        library[f"K5 L={nl}"] = cuda_ms(lambda: torch.einsum("atc,btc->abc", e, e))
        library[f"K6 L={nl}"] = cuda_ms(lambda: torch.einsum("abc,btc->atc", h, e))
    for k, (ms, plain_ms) in times.items():
        lib = f", one einsum {library[k]:.4f} ms" if k in library else ""
        eager = f" ({eager_ms[k]:.4f} ms per eager wrapper call)" if k in eager_ms else ""
        fma = f", fma {fma_ms[k]:.4f} ms" if k in fma_ms else ""
        print(f"  {k} time per launch: kernel {ms:.4f} ms{eager}{fma}, plain {plain_ms:.4f} ms"
              f"{lib}")
    errs.update({"K1": k1_err, "K2": k2_err, "K2wf": wf_err, "K7f": k7f_err, "K7b": k7b_err})
    windowed = {"K1": {"windowed_max_abs_err": k1w_err, "windowed_ms": windowed_ms["K1"]},
                "K2": {"windowed_max_abs_err": k2w_err, "windowed_ms": windowed_ms["K2"]}}

    # Bounds from these shapes. A product is one [T, C] x [C, C] matrix
    # product; an activation or cotangent array is T * C elements.
    item = x0.element_size()
    act, product, weights = T * C * item, 2.0 * T * C * C, 4 * C * C * item
    kg = len(groups[0].dils)
    tg = float(np.mean([sum(g_ is not None for g_ in group_args(g)[1]) for g in groups]))
    bounds = {
        # x in, out and mask bytes out; dilated conv (3 products) + residual.
        "K1": bound(2 * act + T * C + weights, 4 * product, dtype_name),
        # dx in and out, the tap cotangent (10 of 30 layers), two mask arrays.
        "K2": bound((2 + len(STYLE) / LAYERS) * act + 2 * T * C + weights, 4 * product,
                    dtype_name),
        # dx in and out, the group's tap cotangents (mean over the groups
        # timed), k + 1 mask arrays.
        "K2wf": bound((2 + tg) * act + (kg + 1) * T * C + kg * weights, 4 * kg * product,
                      dtype_name),
        "K7f": bound(2 * act + weights, 4 * product, dtype_name),
        # x, g in, dx out; the conv again for the gate, then K2's 4 products.
        "K7b": bound(3 * act + weights, 7 * product, dtype_name),
    }
    for nl in (10, 30):
        pairs = nl * (nl + 1) // 2  # the gram is symmetric
        bounds[f"K5 L={nl}"] = bound(nl * act + nl * nl * C * 4, 2.0 * pairs * T * C, dtype_name)
        bounds[f"K6 L={nl}"] = bound(2 * nl * act + nl * nl * C * 4, 2.0 * nl * nl * T * C,
                                     dtype_name)
    for k, b in bounds.items():
        print(f"  {k} bound: {b['bound_ms']:.4f} ms by {b['bound_by']}")
    return {k: dict(max_abs_err=errs[k], ms=times[k][0], plain_ms=times[k][1],
                    library_ms=library.get(k), **bounds[k], **windowed.get(k, {})) for k in errs}


def slice_phase(params, dev, style_ids, cont_ids) -> None:
    """One float32 loss + waveform gradient at full geometry: kernels on the
    card against the plain versions on the CPU."""
    import torch

    from audio_style_transfer_tpu_torch.models.wavenet_ae import WaveNetAEConfig
    from audio_style_transfer_tpu_torch.signal.mu_law import mu_law_numpy
    from audio_style_transfer_tpu_torch.transfer.losses import (
        LossSpec,
        transfer_embeds,
        transfer_loss,
    )

    cfg = WaveNetAEConfig()
    spec = LossSpec(style_layer_ids=style_ids, cont_lyr_ids=cont_ids)
    content = mu_law_numpy(synth_audio(1.1, kind="content")[:T][None]).astype(np.float32)
    style = mu_law_numpy(synth_audio(1.1, kind="style")[:T][None]).astype(np.float32)
    out = {}
    for where in ("cpu", dev):
        p = {k: {n: v.to(where) for n, v in e.items()} for k, e in params.items()
             if k.startswith("ae_")}
        with torch.no_grad():
            phi_c, _ = transfer_embeds(p, torch.tensor(content, device=where), cfg, spec)
            _, phi_s = transfer_embeds(p, torch.tensor(style, device=where), cfg, spec)
        x = torch.tensor(content[0], device=where).requires_grad_(True)
        loss, _ = transfer_loss(p, x[None], phi_c, phi_s, cfg, spec)
        (g,) = torch.autograd.grad(loss, x)
        out[str(where)] = (loss.detach().cpu(), g.cpu())
    (lc, gc), (lg, gg) = out["cpu"], out[str(dev)]
    print(f"[slice float32, style taps {style_ids[0]}..{style_ids[-1]}, content tap "
          f"{cont_ids}] loss card {float(lg):.6f} cpu {float(lc):.6f}")
    check("loss", lg, lc, 1e-4)
    # A relu gate within rounding of zero can flip between the two paths
    # (the K1 check above shows a few mask bytes in a million per layer);
    # a flip changes that element's cotangent by about its own size, so the
    # gradient is held in relative L2 norm rather than elementwise. On the
    # CPU alone, moving every trunk weight by one float32 ulp moves the
    # stack-0 gradient by 8.9e-4 in relative L2, hence the tolerance of 5e-3.
    l2 = float((gg - gc).norm() / gc.norm())
    max_abs = float((gg - gc).abs().max())
    ok = l2 <= 5e-3
    print(f"  waveform gradient: rel L2 {l2:.3e} (tol 5e-03), max|d| {max_abs:.3e} "
          f"of max {float(gc.abs().max()):.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("waveform gradient: card and CPU paths disagree")


# Bare-evaluation paths: overrides of the bf16 TransferSpec the CLI builds.
EVAL_PATHS = {
    "stack 0": dict(stack=0, cont_lyr_ids=(29,)),
    "full stack": dict(stack=None, cont_lyr_ids=(25,)),
}


def make_eval(params, dev, **path):
    """The bf16 engine of one path and its loss+gradient function, with the
    targets the CLI computes from the synthetic clips: (vg, x), x the
    content window in mu-law space. vg(x) returns (loss, gradient)."""
    import torch

    from audio_style_transfer_tpu_torch.signal.mu_law import mu_law_numpy
    from audio_style_transfer_tpu_torch.transfer.engine import StyleTransfer, TransferSpec
    from audio_style_transfer_tpu_torch.transfer.grams import l2_normalize
    from audio_style_transfer_tpu_torch.transfer.losses import transfer_loss

    spec = TransferSpec(**{**dict(batch_size=T, compute_dtype="bfloat16", fused_encoder=True,
                                  write_artifacts=False, device=str(dev)), **path})
    engine = StyleTransfer(spec, params)
    content = synth_audio(2.0, kind="content")
    style = synth_audio(2.0, kind="style")
    phi_c = engine._tensor(engine.get_embeds(content[:T]))
    phi = engine.get_embeds(content[:T], is_content=False)
    phi = phi + engine.get_style_phi(style) - engine.get_style_phi(content)
    phi_s = engine._tensor(l2_normalize(torch.as_tensor(phi), axes=(1, 2)))

    def vg(x):
        xv = x.detach().requires_grad_(True)
        loss, _ = transfer_loss(engine.params, xv[None, :], phi_c, phi_s, engine.cfg,
                                engine.loss_spec)
        (g,) = torch.autograd.grad(loss, xv)
        return loss.detach(), g

    return vg, engine._tensor(mu_law_numpy(content[:T][None]))[0]


def bare_eval_ms(vg, x, evals: int = 30) -> tuple[float, float]:
    """(device, host) ms per evaluation of a loop of ``evals`` bare
    loss+gradient evaluations: CUDA events around the loop (the stream's time,
    idle gaps included) and the host clock around the same loop, drained."""
    import torch

    for _ in range(3):
        loss, g = vg(x)
    if not (math.isfinite(float(loss)) and bool(torch.isfinite(g).all())):
        raise AssertionError("bare evaluation: the loss or the gradient is not finite")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for _ in range(evals):
        vg(x)
    end.record()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / evals
    return start.elapsed_time(end) / evals, host


def device_launches(fn) -> int:
    """Kernels, copies and memsets that one call of fn() puts on the card
    (torch.profiler's device events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    count = sum(e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    if count <= 0:
        raise RuntimeError("torch.profiler recorded no device event")
    return count


def eval_phase(params, dev, smi: str) -> None:
    """A bare bf16 loss+gradient evaluation at stack 0 and at the full stack:
    its time, and what it launches (the gram backward is one K6)."""
    from audio_style_transfer_tpu_torch.ops import _build

    for label, path in EVAL_PATHS.items():
        vg, x = make_eval(params, dev, **path)
        device_ms, host_ms = bare_eval_ms(vg, x)
        _build.reset_launches()
        vg(x)
        per_eval = {k: v for k, v in _build.LAUNCHES.items() if v}
        if per_eval != {"K1": LAYERS, "K2": LAYERS, "K5": 1, "K6": 1}:
            raise AssertionError(f"[eval bf16 {label}] launched {per_eval}")
        print(f"[eval bf16 {label}] device {device_ms:.3f} ms, host {host_ms:.3f} ms per "
              f"evaluation over 30; {device_launches(lambda: vg(x))} launches per evaluation, of "
              f"the hand-written kernels {per_eval} ({smi})")


def regularizer_phase(params, dev) -> None:
    """The STFT L1 regularizer's value and gradient, card against CPU
    (float32), then one More-Thuente line search on the card along the
    steepest descent of the stack-0 loss with gamma = 1e-3."""
    import torch

    from audio_style_transfer_tpu_torch.models.wavenet_ae import WaveNetAEConfig
    from audio_style_transfer_tpu_torch.signal.mu_law import inv_mu_law, mu_law_numpy
    from audio_style_transfer_tpu_torch.signal.stft import stft_l1
    from audio_style_transfer_tpu_torch.transfer.lbfgs import LBFGSOptions, _mt_line_search
    from audio_style_transfer_tpu_torch.transfer.losses import (
        LossSpec,
        transfer_embeds,
        transfer_loss,
    )

    content = mu_law_numpy(synth_audio(1.1, kind="content")[:T][None]).astype(np.float32)
    style = mu_law_numpy(synth_audio(1.1, kind="style")[:T][None]).astype(np.float32)
    out = {}
    for where in ("cpu", dev):
        x = torch.tensor(content[0], device=where).requires_grad_(True)
        reg = stft_l1(inv_mu_law(x))
        (g,) = torch.autograd.grad(reg, x)
        out[str(where)] = (reg.detach().cpu(), g.cpu())
    (rc, gc), (rg, gg) = out["cpu"], out[str(dev)]
    # The same float32 FFT of 1024 points in two libraries: about 1e-6.
    print(f"[stft_l1 float32] card {float(rg):.8f} cpu {float(rc):.8f}")
    check("stft_l1 value", rg, rc, 1e-5)
    check("stft_l1 gradient", gg, gc, 1e-5)

    cfg = WaveNetAEConfig()
    spec = LossSpec(style_layer_ids=STYLE, cont_lyr_ids=(29,), gamma=1e-3)
    p = {k: {n: v.to(dev) for n, v in e.items()} for k, e in params.items()
         if k.startswith("ae_")}
    with torch.no_grad():
        phi_c, _ = transfer_embeds(p, torch.tensor(content, device=dev), cfg, spec)
        _, phi_s = transfer_embeds(p, torch.tensor(style, device=dev), cfg, spec)

    def vg(x):
        xv = x.detach().requires_grad_(True)
        loss, _ = transfer_loss(p, xv[None], phi_c, phi_s, cfg, spec)
        (g,) = torch.autograd.grad(loss, xv)
        return loss.detach().cpu(), g

    x0 = torch.tensor(content[0], device=dev)
    f0, g0 = vg(x0)
    d = -g0
    dphi0 = torch.sum(g0 * d).cpu()

    def vg_1d(a):
        fa, ga = vg(x0 + a.to(dev) * d)
        return fa, torch.sum(ga * d).cpu(), ga

    opts = LBFGSOptions()
    c1, c2 = opts.resolved_c1c2()
    a, f, g, n_evals, ok = _mt_line_search(vg_1d, f0, g0, dphi0,
                                           1.0 / torch.sqrt(torch.sum(d * d)).cpu(), opts)
    dphi = float(torch.sum(g * d))
    # The search tests in float32; one ulp of f0 of slack for this recheck.
    armijo = float(f) <= float(f0) + c1 * float(a) * float(dphi0) + 1e-6 * abs(float(f0))
    curvature = abs(dphi) <= c2 * abs(float(dphi0)) * (1 + 1e-6)
    print(f"[MT line search on the card, gamma 1e-3] f0 {float(f0):.6f} -> f {float(f):.6f} at "
          f"step {float(a):.4e} in {n_evals} evals; dphi0 {float(dphi0):.4e}, dphi {dphi:.4e}; "
          f"sufficient decrease {armijo}, curvature {curvature}")
    if not (ok and math.isfinite(float(f)) and bool(torch.isfinite(g).all())
            and armijo and curvature):
        raise AssertionError("MT line search: the accepted step fails the Wolfe conditions")


def longform_phase(dev, wavefront: bool, epochs: int):
    """The chunked long-form CLI (bf16, stack 0, OT target of 8 components,
    gamma 1e-3) on a synthetic clip of WINDOWS windows plus a remainder;
    returns (launches, evals, wall seconds)."""
    import torch

    from audio_style_transfer_tpu_torch.cli.transfer import main
    from audio_style_transfer_tpu_torch.ops import _build, chain
    from audio_style_transfer_tpu_torch.transfer import longform
    from audio_style_transfer_tpu_torch.transfer.engine import StyleTransfer

    label = f"longform, wavefront {'on' if wavefront else 'off'}"
    captured, seconds_in = {}, {}

    def timed(name, fn):
        """fn, with its wall time (the device drained either side) kept."""
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds_in[name] = time.perf_counter() - t0
            captured[name] = out
            return out
        return run

    originals = (longform.transfer_longform, longform._ot_transform_gram,
                 StyleTransfer.optimize_batch)

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "src")
        os.makedirs(src)
        seconds = (WINDOWS * T + 1000) / 16000
        write_wav(os.path.join(src, "content.wav"), synth_audio(seconds, kind="content"), 16000)
        write_wav(os.path.join(src, "style.wav"), synth_audio(1.1, kind="style"), 16000)
        argv = ["content", "style", "--dir", src, "--outdir", os.path.join(tmp, "out"),
                "--logdir", os.path.join(tmp, "log"), "--longform", "--ot_components", "8",
                "--gamma", "1e-3", "--stack", "0", "--epochs", str(epochs),
                "--precision", "bfloat16", "--fused", "--random_init", "--device", str(dev)]
        print(f"[{label}] {' '.join(argv[:2])} {' '.join(argv[8:])}")
        buf = io.StringIO()
        was = chain._BWD_WAVEFRONT
        chain._BWD_WAVEFRONT = wavefront
        longform.transfer_longform = timed("transfer_longform", originals[0])
        longform._ot_transform_gram = timed("OT target", originals[1])
        StyleTransfer.optimize_batch = timed("optimize_batch", originals[2])
        try:
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                audio = main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(_build.LAUNCHES)
        finally:
            chain._BWD_WAVEFRONT = was
            (longform.transfer_longform, longform._ot_transform_gram,
             StyleTransfer.optimize_batch) = originals
        wavs = [os.path.join(r, f) for r, _, fs in os.walk(os.path.join(tmp, "out"))
                for f in fs if f == "longform.wav"]
        if len(wavs) != 1:
            raise AssertionError(f"{label}: expected one longform.wav, found {wavs}")
        with wave.open(wavs[0], "rb") as w:
            n_written = w.getnframes()
    text = buf.getvalue()
    print(text, end="")
    if "OT transform: nmf rec err" not in text:
        raise AssertionError(f"{label}: the OT line was not printed")
    want_len = WINDOWS * T - (WINDOWS - 1) * 256  # _stitch at crossfade 256
    if audio.shape != (want_len,) or n_written != want_len or not np.all(np.isfinite(audio)):
        raise AssertionError(f"{label}: output of {audio.shape} / {n_written} samples, "
                             f"expected {want_len} finite ones")
    per = captured["transfer_longform"].per_window
    if len(per["epochs_done"]) != WINDOWS:
        raise AssertionError(f"{label}: {len(per['epochs_done'])} windows, expected {WINDOWS}")
    for i, done in enumerate(per["epochs_done"]):
        rows = per["metrics"][i, :done]
        losses = [float(v) for v in rows[:, 0]]
        if done < 1 or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{label}: window {i} losses {losses}")
        if any(b > a for a, b in zip(losses, losses[1:])):
            raise AssertionError(f"{label}: window {i} losses increase: {losses}")
        if not np.all(rows[:, 3] > 0):
            raise AssertionError(f"{label}: window {i} regularizer column {rows[:, 3]}")
        print(f"[{label}] window {i}: {done} epochs, evals {per['evals'][i, :done].tolist()}, "
              f"losses {losses}, regularizer {[float(v) for v in rows[:, 3]]}")
    evals = int(np.sum(per["evals"]))
    # Per loss+gradient evaluation the backward runs the plan's 3 groups and
    # 18 single layers (30 single layers with the wavefront off); K1 also
    # runs in the gradient-free passes (targets, OT taps, closing forwards).
    want = ({"K2wf": 3 * evals, "K2": 18 * evals} if wavefront
            else {"K2wf": 0, "K2": 30 * evals})
    got = {k: launches[k] for k in want}
    if got != want or launches["K1"] % LAYERS or launches["K1"] < LAYERS * evals:
        raise AssertionError(f"{label}: launches {launches} for {evals} evals, expected {want} "
                             f"and K1 a multiple of {LAYERS} of at least {LAYERS * evals}")
    check_launches(label, launches, {"K1", "K2", "K5", "K6"} | ({"K2wf"} if wavefront else set()),
                   evals)
    print(f"[{label}] {WINDOWS} windows, {evals} L-BFGS evals (K2wf {launches['K2wf']}, K2 "
          f"{launches['K2']}, K1 {launches['K1']}) in {wall:.2f} s wall "
          f"({evals / wall:.2f} evals/s, setup included); OT target "
          f"{seconds_in['OT target']:.2f} s, optimize_batch {seconds_in['optimize_batch']:.2f} s "
          f"({1e3 * seconds_in['optimize_batch'] / evals:.3f} ms per eval), transfer_longform "
          f"{seconds_in['transfer_longform']:.2f} s")
    return launches, evals, wall


def check_launches(label: str, launches: dict, expected: set, grad_evals: int) -> None:
    """The path launched every kernel of ``expected`` and no other, and its
    gram backward is K6 and nothing else: one launch per evaluation that took
    a gradient, each after a K5 of its own (K5 also runs in the gradient-free
    passes that make the targets)."""
    missing = [k for k in sorted(expected) if launches[k] == 0]
    extra = [k for k in KERNELS if k not in expected and launches[k] != 0]
    if missing or extra:
        raise AssertionError(f"{label}: kernels not launched {missing}, launched but not on "
                             f"this path {extra}: {launches}")
    if "K6" not in expected:  # the Gatys gram is a plain matmul: no gram kernel at all
        print(f"[{label}] launches {launches}: {sorted(expected)} all > 0, the rest 0 ok")
        return
    if launches["K6"] != grad_evals or launches["K5"] < grad_evals:
        raise AssertionError(f"{label}: K6 {launches['K6']} and K5 {launches['K5']} launches for "
                             f"{grad_evals} evaluations that took a gradient")
    print(f"[{label}] launches {launches}: {sorted(expected)} all > 0, the rest 0; K6 == "
          f"{grad_evals} gradient evaluations <= K5 ok")


def check_losses(label: str, losses, audio_or_x, samples: int = T, band=None) -> None:
    """Finite, not increasing across epochs, a finite waveform of ``samples``;
    with ``band`` = (centre, relative half-width) the final loss lies in it."""
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{label}: non-finite losses {losses}")
    if any(b > a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"{label}: losses increase across epochs: {losses}")
    if audio_or_x.shape != (samples,) or not np.all(np.isfinite(audio_or_x)):
        raise AssertionError(f"{label}: the output waveform is not finite [{samples}]")
    if band is not None:
        centre, width = band
        ok = abs(losses[-1] - centre) <= width * centre
        print(f"[{label}] final loss {losses[-1]:.4f} against {centre} +- {100 * width:.0f}% "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label}: final loss {losses[-1]} outside the band")


def cli_phase(dev, label: str, path_args: list, expected: set, precision: str = "bfloat16",
              band=None):
    """The port's CLI, 3 epochs of transfer in ``precision``; returns
    (launches, evals, wall seconds, final loss)."""
    import torch

    from audio_style_transfer_tpu_torch.cli.transfer import main
    from audio_style_transfer_tpu_torch.ops import _build

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "src")
        os.makedirs(src)
        write_wav(os.path.join(src, "content.wav"), synth_audio(3.0, kind="content"), 16000)
        write_wav(os.path.join(src, "style.wav"), synth_audio(3.0, kind="style"), 16000)
        argv = ["content", "style", "--dir", src, "--outdir", os.path.join(tmp, "out"),
                "--logdir", os.path.join(tmp, "log"), *path_args,
                "--precision", precision, "--fused", "--random_init", "--no_artifacts",
                "--epochs", "3", "--device", str(dev)]
        print(f"[{label}] {' '.join(argv[:2])} {' '.join(argv[8:])}")
        buf = io.StringIO()
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            audio = main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
    text = buf.getvalue()
    print(text, end="")
    rows = re.findall(r"Ep (\d+)/\d+ - evals (\d+) - loss (\S+)", text)
    if not rows:
        raise AssertionError(f"{label}: the CLI printed no epoch lines")
    losses = [float(r[2]) for r in rows]
    evals = sum(int(r[1]) for r in rows)
    check_losses(label, losses, audio, band=band)
    check_launches(label, launches, expected, evals)
    print(f"[{label}] {len(rows)} epochs, losses {losses}, {evals} L-BFGS evals in "
          f"{wall:.2f} s wall ({evals / wall:.2f} evals/s, setup included)")
    return launches, evals, wall, losses[-1]


def exact_flavours_phase(params, dev, dtype_name: str) -> None:
    """The exact long-form loss and its waveform gradient at the 1e-6 start
    (the optimizer's first evaluation) on the 15 s clip, full width, stack 0,
    gamma 1e-3: one unmasked window against the scan over halo-extended
    windows with the pad masked. Both flavours run the same kernels row for
    row on the valid rows; what differs is the order of the gram's and the
    content term's float32 sums across windows (about 1e-6), and in bfloat16
    a tap cotangent that lands on the other side of a rounding boundary
    (2^-8 of it). Hence loss rtol 1e-4 / 1e-3 and gradient max|d| within
    1e-4 / 2e-2 of its largest entry (float32 / bfloat16)."""
    import torch

    from audio_style_transfer_tpu_torch.parallel import halo
    from audio_style_transfer_tpu_torch.signal.mu_law import mu_law_numpy
    from audio_style_transfer_tpu_torch.transfer.engine import StyleTransfer, TransferSpec

    engine = StyleTransfer(TransferSpec(stack=0, gamma=1e-3, compute_dtype=dtype_name,
                                        fused_encoder=True, write_artifacts=False,
                                        device=str(dev)), params)
    t_valid = (EXACT_SAMPLES // 4096) * 4096
    t_total = -(-t_valid // SCAN_WINDOW) * SCAN_WINDOW
    content = synth_audio(EXACT_SAMPLES / 16000, kind="content")[:t_valid]
    xq = engine._tensor(mu_law_numpy(content[None]))
    phi_s = engine._tensor(engine.get_style_phi(synth_audio(3.0, kind="style")))
    cfg, lspec = engine.cfg, engine.loss_spec
    with torch.no_grad():
        phi_c, _ = halo.make_scan_exact_embeds_fn(cfg, lspec, t_valid, t_valid)(engine.params, xq)
        phi_c = phi_c.to(torch.float32)
    x = torch.full((1, t_valid), 1e-6, device=dev)
    pad = t_total - t_valid
    f1, g1 = halo.make_scan_exact_value_and_grad_fn(cfg, lspec, t_valid, t_valid)(
        engine.params, x, phi_c, phi_s)
    f2, g2 = halo.make_scan_exact_value_and_grad_fn(cfg, lspec, t_total, SCAN_WINDOW, t_valid)(
        engine.params, torch.nn.functional.pad(x, (0, pad)),
        torch.nn.functional.pad(phi_c, (0, 0, 0, pad)), phi_s)
    torch.cuda.synchronize()
    loss_tol, grad_tol = {"float32": (1e-4, 1e-4), "bfloat16": (1e-3, 2e-2)}[dtype_name]
    print(f"[exact flavours {dtype_name}] first evaluation on {t_valid} samples: one window "
          f"{float(f1):.6f}, scan of {t_total // SCAN_WINDOW} windows {float(f2):.6f}")
    check("loss, scan against one window", f2, f1, loss_tol)
    check("waveform gradient, scan against one window", g2[:, :t_valid], g1, grad_tol)
    if bool(g2[:, t_valid:].any()):
        raise AssertionError("exact scan: the pad tail's gradient is not zero")


def exact_phase(dev, label: str, scan_window):
    """The exact long-form CLI (bf16, stack 0, gamma 1e-3, 2 epochs) on the
    15 s clip, as one window or as a scan; returns (launches, evals, wall
    seconds, final loss)."""
    import torch

    from audio_style_transfer_tpu_torch.cli.transfer import main
    from audio_style_transfer_tpu_torch.ops import _build
    from audio_style_transfer_tpu_torch.transfer import lbfgs, longform

    scan = scan_window is not None
    quantum = 512 if scan else 4096
    t_valid = (EXACT_SAMPLES // quantum) * quantum
    t_total = -(-t_valid // scan_window) * scan_window if scan else t_valid
    n_win = t_total // scan_window if scan else 1
    captured, in_lbfgs = {}, [0.0]
    originals = (longform.transfer_exact, lbfgs.lbfgs_minimize)

    def keep_result(*args, **kwargs):
        captured["res"] = originals[0](*args, **kwargs)
        return captured["res"]

    def timed_minimize(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = originals[1](*args, **kwargs)
        torch.cuda.synchronize()
        in_lbfgs[0] += time.perf_counter() - t0
        return out

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "src")
        os.makedirs(src)
        write_wav(os.path.join(src, "content.wav"),
                  synth_audio(EXACT_SAMPLES / 16000, kind="content"), 16000)
        write_wav(os.path.join(src, "style.wav"), synth_audio(3.0, kind="style"), 16000)
        argv = ["content", "style", "--dir", src, "--outdir", os.path.join(tmp, "out"),
                "--logdir", os.path.join(tmp, "log"), "--exact",
                *(["--scan_window", str(scan_window)] if scan else []),
                "--gamma", "1e-3", "--stack", "0", "--epochs", "2", "--precision", "bfloat16",
                "--fused", "--random_init", "--no_artifacts", "--device", str(dev)]
        print(f"[{label}] {' '.join(argv[:2])} {' '.join(argv[8:])}")
        buf = io.StringIO()
        longform.transfer_exact, lbfgs.lbfgs_minimize = keep_result, timed_minimize
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                audio = main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(_build.LAUNCHES)
            peak = torch.cuda.max_memory_allocated()
        finally:
            longform.transfer_exact, lbfgs.lbfgs_minimize = originals
    print(buf.getvalue(), end="")
    per = captured["res"].per_window
    losses = [float(v) for v in per["metrics"]]
    evals = int(np.sum(per["evals"]))
    check_losses(label, losses, audio, samples=t_valid)
    if per["t_optimized"] != t_total or per["x"].shape != (1, t_total):
        raise AssertionError(f"{label}: optimized {per['t_optimized']} samples, x "
                             f"{per['x'].shape}, expected {t_total}")
    # Per evaluation every window runs the trunk forward (30 K1, one K5) and
    # backward (30 K2, one K6); the scan's two-pass scheme runs each window's
    # forward once more without a graph. Gradient-free passes: the style
    # statistics of the style clip (2 engine windows) and the content clip
    # (5), and the exact targets (every window once).
    passes = 2 if scan else 1
    want = {"K1": LAYERS * (passes * n_win * evals + 7 + n_win),
            "K2": LAYERS * n_win * evals, "K2wf": 0,
            "K5": passes * n_win * evals + 7 + n_win, "K6": n_win * evals, "K7f": 0, "K7b": 0}
    if launches != want:
        raise AssertionError(f"{label}: launches {launches} for {evals} evaluations over "
                             f"{n_win} windows, expected {want}")
    print(f"[{label}] launches {launches} == per evaluation K1 {LAYERS * passes * n_win}, K2 "
          f"{LAYERS * n_win}, K5 {passes * n_win}, K6 {n_win}, plus {7 + n_win} gradient-free "
          f"passes ok")
    print(f"[{label}] {per['epochs_done']} epochs, evals {per['evals'].tolist()}, losses {losses}; "
          f"t_optimized {per['t_optimized']}, t_out {len(audio)}; {evals} evals in {wall:.2f} s "
          f"wall ({evals / wall:.2f} evals/s, setup included), {1e3 * in_lbfgs[0] / evals:.3f} ms "
          f"per eval in L-BFGS; peak memory {peak / 2**30:.3f} GiB")
    return launches, evals, wall, losses[-1]


def per_layer_phase(params, dev):
    """One bf16 engine epoch of the per-layer flavour (fused_encoder=True,
    chain_encoder=False) at the full stack, content tap 25; returns
    (launches, evals, wall seconds)."""
    import torch

    from audio_style_transfer_tpu_torch.ops import _build
    from audio_style_transfer_tpu_torch.transfer.engine import StyleTransfer, TransferSpec
    from audio_style_transfer_tpu_torch.transfer.grams import l2_normalize

    label = "per-layer engine"
    spec = TransferSpec(stack=None, cont_lyr_ids=(25,), batch_size=T, epochs=1, maxiter=20,
                        compute_dtype="bfloat16", fused_encoder=True, chain_encoder=False,
                        write_artifacts=False, device=str(dev))
    print(f"[{label}] stack None, cont_lyr_ids (25,), bf16, fused_encoder=True, "
          f"chain_encoder=False, 1 epoch, maxiter {spec.maxiter}")
    content = synth_audio(2.0, kind="content")
    style = synth_audio(2.0, kind="style")
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    engine = StyleTransfer(spec, params)
    phi_c = engine.get_embeds(content[:T])
    phi = engine.get_embeds(content[:T], is_content=False)
    phi = phi + engine.get_style_phi(style) - engine.get_style_phi(content)
    phi = l2_normalize(torch.as_tensor(phi), axes=(1, 2)).numpy()
    res = engine.optimize(phi_c, phi)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    losses = [float(v) for v in res["metrics"][:, 0]]
    evals = int(np.sum(res["evals"]))
    check_losses(label, losses, res["x"][0])
    check_launches(label, launches, {"K7f", "K7b", "K5", "K6"}, evals)
    print(f"[{label}] losses {losses}, {evals} L-BFGS evals in {wall:.2f} s wall "
          f"({evals / wall:.2f} evals/s, setup included)")
    return launches, evals, wall


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script needs a GPU")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "audio_style_transfer_tpu_torch")):
        raise SystemExit("chip_smoke: run it from a checkout of the repository")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from audio_style_transfer_tpu_torch.models.wavenet_ae import WaveNetAEConfig, init_params
    from audio_style_transfer_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.lib()
    print(f"[build] kernels ready in {time.perf_counter() - t0:.1f} s "
          f"({_build.library_path().name})")

    params = init_params(0, WaveNetAEConfig())
    results, exact_shapes = {}, {}
    for dtype_name in ("float32", "bfloat16"):
        results[dtype_name] = kernel_phase(dtype_name, params, dev)
        exact_shapes[dtype_name] = exact_shapes_phase(dtype_name, params, dev)
    slice_phase(params, dev, STYLE, (29,))
    slice_phase(params, dev, FULL, (25,))
    regularizer_phase(params, dev)
    eval_phase(params, dev, smi)
    for dtype_name in ("float32", "bfloat16"):
        exact_flavours_phase(params, dev, dtype_name)
    grams = {"K1", "K2", "K5", "K6"}
    cli_paths = {  # path: (CLI arguments, kernels, band of the float32 final loss)
        "cli stack 0": (["--stack", "0"], grams, None),
        "cli full stack": (["--cont_lyrs", "25"], grams, (F32_FULL_STACK_LOSS, F32_BAND)),
        "cli gatys": (["--gatys", "--stack", "0"], {"K1", "K2"}, None),
    }
    runs = {}
    for label, (path_args, expected, band) in cli_paths.items():
        runs[label] = cli_phase(dev, label, path_args, expected)
        runs[f"{label}, float32"] = cli_phase(dev, f"{label}, float32", path_args, expected,
                                              precision="float32", band=band)
    runs.update({
        "per-layer engine": per_layer_phase(params, dev),
        "longform, wavefront on": longform_phase(dev, wavefront=True, epochs=2),
        "longform, wavefront off": longform_phase(dev, wavefront=False, epochs=1),
        "exact, one window": exact_phase(dev, "exact, one window", None),
        "exact, scan": exact_phase(dev, "exact, scan", SCAN_WINDOW),
    })
    for label, (_, evals, wall, *_) in runs.items():
        print(f"[{label}] {evals} evals, {evals / wall:.2f} evals/s setup included ({smi})")
    # bf16 against f32 from the same 1e-6 start. Printed, not yet a check: the
    # bf16 zoom search from that start lands in one of two basins by rounding
    # (ROADMAP.md, faults, item 1), in the JAX package as in the port.
    for label in cli_paths:
        b16, f32 = runs[label][3], runs[f"{label}, float32"][3]
        print(f"[{label}] final loss bf16 {b16:.4f} / f32 {f32:.4f} = {b16 / f32:.4f}")
    launches = {k: sum(r[0][k] for r in runs.values()) for k in KERNELS}

    src = "audio_style_transfer_tpu_torch/csrc/"
    meta = {  # kernel: (name, source, replaces, the timing key)
        "K1": ("trunk forward layer", src + "trunk_mma.cu",
               "audio_style_transfer_tpu/ops/pallas_chain.py:521", "K1"),
        "K2": ("trunk backward layer", src + "trunk_mma.cu",
               "audio_style_transfer_tpu/ops/pallas_chain.py:672", "K2"),
        "K2wf": ("trunk backward wavefront group of 4 layers", src + "trunk_wf.cu",
                 "audio_style_transfer_tpu/ops/pallas_chain.py:851", "K2wf"),
        "K5": ("pair gram forward, L=30", src + "gram.cu",
               "audio_style_transfer_tpu/ops/pallas_gram.py:72", "K5 L=30"),
        "K6": ("pair gram backward, L=30", src + "gram.cu",
               "audio_style_transfer_tpu/ops/pallas_gram.py:109", "K6 L=30"),
        "K7f": ("encoder block forward", src + "trunk.cu",
                "audio_style_transfer_tpu/ops/pallas_encoder.py:203", "K7f"),
        "K7b": ("encoder block backward", src + "trunk.cu",
                "audio_style_transfer_tpu/ops/pallas_encoder.py:288", "K7b"),
    }
    kernels = []
    for k, (name, source, replaces, key) in meta.items():
        r = results["bfloat16"][key]
        kernels.append({"name": f"{k} {name} (bf16)", "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[k],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
        if "windowed_ms" in r:  # K1, K2: the same kernel with a valid window
            kernels[-1].update(windowed_ms=r["windowed_ms"],
                               windowed_max_abs_err=r["windowed_max_abs_err"])
        if k in exact_shapes["bfloat16"]:  # K1, K2, K5 (L=10), K6 (L=10)
            kernels[-1]["exact_shapes_max_abs_err"] = exact_shapes["bfloat16"][k]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
