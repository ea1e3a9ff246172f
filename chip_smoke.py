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
     K7f/K7b layer by layer on the plain chain's own inputs (all four are
     the tensor-core kernels in bfloat16 and the FMA kernels in float32;
     K7b also bit for bit against K2 fed K1's gate; K2's and K7b's two
     phases timed under torch.profiler by their kernels' names), K2-wf on
     each group of
     the wavefront plan (the tensor-core kernel in bfloat16, the FMA kernel
     in float32, bit for bit against the K2 launches it replaces; timed as a
     replayed CUDA graph beside its eager call and the K2 launches it
     replaces in one graph), K5
     and K6 on the stack-0 taps {0..9} (L=10) and on all 30 taps (L=30),
     and on two clips of a ragged
     T, K5 twice on the same inputs for equal bits, both timed as a
     replayed CUDA graph with one torch.einsum beside each as a yardstick;
     K1, K2, K7f, K7b and K2-wf once more with a valid window whose edges
     cut 128-row tiles (the exact long-form scan's edge windows), against
     their windowed plain versions and timed beside the unwindowed kernels;
     then each kernel against its plain version at the shapes the exact
     long-form runs give it: K1, K2 and K2-wf (also bit for bit against the
     K2 launches) on the chained scan's 40960-row window with its two
     edge windows and with none and on the single window's 237568 rows, K5
     and K6 on the scan's cropped 32768-row gram and the single window's,
     K7f and K7b on the per-layer scan's 24576-row window with its two edge
     windows and with none; the decoder block's four epilogue kernels
     (ops/decoder.py) at the training step's 32 x 6144 rows against their
     plain versions (the forwards bit for bit), each timed beside its plain
     version and its bound by bytes; the per-layer (Gatys) gram kernels
     K8f/K8b at the 15 s clip's 237568 rows and L=30: K8f against the
     float64 gram (and closer to it than the plain float32 route), K8b
     against autograd of the plain route, each timed beside it and its bound
     from portbench/counts_layer_gram.py; in bfloat16 the merged-taps pack
     (ops/conv.py::taps_pack) at the training step's shapes, bit for bit the
     plain pad and concatenation, timed beside it and its bound by bytes,
     and K5/K6 at the 15 s clip's 237568 rows at L=30 and L=10, in bf16
     (the tensor-core kernels) and float32 (the FMA kernels): K5 against
     the float64 gram and twice for equal bits, the bf16 K5 also against
     the float32 K5 of the same taps, K6 against its plain composition,
     each timed as a replayed CUDA graph against its bound from
     portbench/counts.py;
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
     stack {K7f, K7b, K5, K6}, the per-layer flavour's exact scan (2.5
     windows of 16384, the edge windows through the windowed K7f / K7b: its
     first evaluation against the chained flavour's, then one epoch) {K7f,
     K7b, K5, K6}, the exact scan of the 15 s clip with the
     wavefront backward on (its first evaluation against the same with it
     off, then 3 L-BFGS iterations; K2-wf with and without a valid window)
     {K1, K2, K2wf, K5, K6}, then the chunked long-form CLI (4 windows,
     --longform --ot_components 8 --gamma 1e-3 --stack 0, 2 epochs) with the
     wavefront backward on {K1, K2, K2wf, K5, K6; K2wf and K2 per evaluation
     as the bf16 plan has groups and single layers: 3 and 18} and once more
     with it off; in every run K6 is launched once
     per evaluation that took a gradient, and K5 at least as often; the
     stack-0 and full-stack CLI runs again in float32 (the full-stack final
     loss held to a band) and the --gatys CLI in both types {K1, K2, K8f, K8b}, with
     the bf16 / f32 ratio of final losses printed per path; `[tf1
     checkpoint]` a full-size NSynth TF1 bundle of init_params(0) written
     without TensorFlow (tools/tf1_bundle.py, with global_step and optimizer
     slots the converter skips), its read, convert_tf1_checkpoint and both
     load_pretrained calls (converting and caching, then the .npz) timed and
     each bit for bit init_params(0), then the stack-0 CLI from
     --ckpt_path <prefix> in bf16 (converting) and f32 (the cache): K1 30, K2
     30, K5 1, K6 1 per evaluation, the f32 losses and launches exactly the
     --random_init run's; then the exact
     long-form CLI (--exact, bf16, --stack 0 --gamma 1e-3) on a 15 s clip as
     one window and as a scan of 32768-sample windows, launches per
     evaluation checked, with evals/s, ms per evaluation and peak memory;
     then generation at full width (init_params(0), f32 unless said):
     `[generate encode]` ``encode`` on 16 clips of 64 000 samples {K1: 30,
     the rest 0}, its peak memory beside what keeping every layer's output
     and mask bytes would hold, the first two clips against the CPU;
     `[generate decoder]` the graphed ``incremental_logits`` against
     ``decode_logits`` on the card (B=2, 4 frames), its first 64 steps
     against the eager step bit for bit and against the CPU, the sampler
     graphed against eager bit for bit; `[generate synth]` ``synthesize``
     over 8 frames at B in {1, 8, 32} x {f32, bf16, int8}: us per sample
     per stream, samples/s, the weight-streaming floor and the ratio to it,
     peak memory, the cond bytes; the eager loop's ms per step;
     `[generate step]` the graphed step's device operations and time by
     kernel (torch.profiler); `[generate cli]` save_embeddings and generate
     (from the .npy files, and from the wavs with --int8) as subprocesses;
     then training at full width (train/trainer.py): `[train parity]` one
     f32 step on 2 x 2048 samples card against CPU (loss, every gradient,
     the updated weights); then in float32 and in bfloat16 `[train trunk
     ...]` the trunk at the step's 32 x 6144 rows: K1 and K2 layer by layer
     against their plain versions, tap 29 and the gradients through K1/K2
     and the recompute against plain autograd, each path's time and peak
     memory, and `[train step float32|bfloat16]` TrainConfig()'s
     step (32 x 6144, remat on): 10 steps on one batch, the loss falling,
     exactly STEP_LAUNCHES of its type per step (K1 and K2 30 each, the
     decoder's gate forward 60, the rest of its epilogue kernels 30; in
     bfloat16 the pack kernel TAPS_PACK_STEP times), ms per step against the
     bound of its operations, samples/s, peak memory, and one step's split
     under torch.profiler (device time by kind, the trunk's weight
     recompute, Adam and the EMA; the busy share); `[train fit]` ``fit``
     over a synthetic TFRecord of 64000-sample examples through the native
     reader (a full group of steps and a partial one), save -> restore bit
     for bit, an EMA ``evaluate`` {K1: 30, gate_fwd: 30, residual_fwd: 30,
     the rest 0}; `[train cli]`
     cli/train.py as a subprocess for 3 iterations, its launches counted;
     then data parallelism and clip sharding (parallel/mesh.py):
     `[dp train nccl, world 1]` ``Trainer(mesh=make_mesh(1))`` over NCCL,
     the bf16 step at 32 x 6144 for 3 steps, bit for bit ``mesh=None``'s,
     ms per step both ways and the gradient all-reduce alone; in the same
     world-1 group `[exact sharded nccl, world 1, float32|bfloat16]`
     ``transfer_exact(mesh=make_mesh(1))`` on the 15 s clip: its first
     evaluation against the one-window flavour's, its launches per
     evaluation {K1: 30, K2: 30, K5: 1, K6: 1}, then 2 epochs (evals, losses,
     ms per evaluation, peak memory, every launch accounted for), and `[tp
     decoder nccl, world 1]` ``tp_decode_logits`` at full width on 4 x 6144
     f32 against ``decode_logits`` (logits, NLL, every weight's gradient,
     ms; the reference launches the decoder's epilogue kernels, the tensor-
     parallel pass no hand-written kernel); then one
     spawned group of 2 ranks sharing the card over gloo (NCCL takes one
     card per rank), each phase against this process's single-rank run:
     `[dp train gloo, 2 ranks on one card]` 3 f32 steps at full width on a
     global batch of 4 x 2048 (losses, the weights after step 1, both ranks
     bit for bit, STEP_LAUNCHES per rank per step, the float32 ones),
     `[clip sharded]`
     ``optimize_batch(mesh=)`` of 8 clips at T=16384 (stack 0, bf16, 2
     epochs of maxiter 20; aggregate evals/s both ways), `[longform
     sharded]` ``transfer_longform(mesh=, windows_per_device=1)`` on the
     long-form cell's clips, `[exact sharded gloo, 2 ranks on one card]`
     the time-sharded evaluation of the 15 s clip in f32 and bf16 against
     the one-window flavour (launches per rank per evaluation checked; ms per
     evaluation, the halo exchange and the all-reduces timed alone), then
     ``transfer_exact(mesh=)`` for 2 bf16 epochs on each rank (its launches
     printed per rank and checked; evaluations and final loss equal on the
     ranks) and `[tp
     decoder gloo, 2 ranks]` (logits and gradients against each rank's own
     ``decode_logits``, the ranks' gradients equal bit for bit); their
     launches go into the totals;
     then the side-car (cuDNN convs, torch.fft and torch.matmul; float32,
     TF32 off) over a synthetic TFRecord of 16 x 64000-sample examples:
     `[baseline train]` cli/baseline_train.py as a subprocess for 12 steps at
     the nfft_1024 geometry (BaselineHParams(): 8 x [512, 256, 1], num_latent
     1984) with a checkpoint, then 10 steps on one batch in this process (the
     loss falling, ms per step by CUDA events, samples/s, the step's 1.86
     TFLOP against its bound, peak memory, one step's split under
     torch.profiler: conv, transposed conv, their backward, Adam, the rest;
     the busy share) and `[baseline parity]` one step card against CPU at a
     shallow spec (loss, gradients, BN statistics); `[baseline
     save_embeddings]` the CLI from that checkpoint, each z [1, 1, 1984]
     against this process's eval encode; `[specgram]` get_baseline_batch's
     features card against CPU and their ms, ispecgram with 1000 Griffin-Lim
     iterations (ms, spectral convergence), 20 iterations card against CPU;
     `[cqt]` a 4 s clip against the host multirate oracle and the CPU, its
     ms; `[output grams]` cli/output_grams.py's ``window_grams`` over 3
     windows of 16384 at the full stack, exactly K1 30 and K5 1 a window,
     the grams against the plain trunk and gram on the card (its launches go
     into the totals);
     then the last modules: `[scipy parity]` transfer/scipy_parity.py's
     ``run_parity`` at full geometry (T=16384, stack 0, float32, TF32 off,
     maxiter 100, 2 seeds, the MT line search): each seed's record, each
     leg's wall and ms per evaluation, every leg's launches exactly K1 30,
     K2 30, K5 1, K6 1 per evaluation and the phase's K1 30 and K5 1 per
     forward pass, each seed held to main()'s rule; `[examples]`
     examples/how_to_use_torch.py and examples/interpolation_torch.py,
     ``main(argv)`` in this process at --sample_length 8192 with random
     weights on synthetic wavs: every wav they write finite and frames x 512
     samples long (the stretched one round(frames x 1.5) x 512), exactly K1
     30 per ``encode`` call, their walls; then one line on the composed
     parity (its TensorFlow oracle is not installed on the card's machine;
     tests/test_torch_composed_parity.py holds it on the CPU);
  6. print the per-kernel JSON line (time, plain time, bound, library time,
     windowed time, the error at the exact runs' shapes and, for
     K1 and K2, at the training step's in both types), then the
     result line.

It imports nothing of JAX. Numbers it prints are for the card it ran on.
"""

from __future__ import annotations

import ast
import contextlib
import dataclasses
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
KERNELS = ("K1", "K2", "K2wf", "K5", "K6", "K7f", "K7b", "K8f", "K8b",
           "gate_fwd", "gate_bwd", "residual_fwd", "residual_bwd", "taps_pack")
# The decoder's fused epilogues (ops/decoder.py) in one remat training step of
# its 30 blocks: the gate in the forward and the re-forward, the residual in
# the forward alone (the re-forward stops at the last tensor the backward
# keeps, the gated input of the res and skip products), each backward once.
DECODER_LAYERS = 30
# The merged-taps pack (ops/conv.py::taps_pack) in one bf16 step: each decoder
# dilated conv's forward, re-forward and input gradient; in the trunk's weight
# recompute (ops/chain.py::TrunkFunction, reference_trunk through conv1d) each
# encoder layer's input and every layer's cotangent but the first's. A float32
# step packs nothing (one float32 product per tap).
TAPS_PACK_STEP = 3 * DECODER_LAYERS + 2 * LAYERS - 1
STEP_LAUNCHES = {dtype_name: {"K1": LAYERS, "K2": LAYERS, "gate_fwd": 2 * DECODER_LAYERS,
                              "gate_bwd": DECODER_LAYERS, "residual_fwd": DECODER_LAYERS,
                              "residual_bwd": DECODER_LAYERS, "taps_pack": packs}
                 for dtype_name, packs in (("float32", 0), ("bfloat16", TAPS_PACK_STEP))}
WINDOWS = 4  # windows of the long-form run
RAGGED_T = 1000  # rows of the gram kernels' ragged check: no multiple of their tiles
# The valid window of the windowed K1/K2 check, in rows: both edges inside a
# 128-row tile of the bf16 kernels and a 64-row tile of the f32 ones.
WINDOW = (1000, T - 1500)
# The exact long-form runs: a 15 s clip; one window trims it to a multiple of
# 4096; the scan trims to a multiple of 512 and pads to 8 windows.
EXACT_SAMPLES = 240000
SCAN_WINDOW = 32768
EXACT_WF_MAXITER = 3  # evaluations of the wavefront exact run: a few
# The per-layer flavour's windowed run: a clip of 2.5 windows of T, as a scan
# whose first and last windows are masked, one epoch of a few evaluations.
PER_LAYER_SAMPLES = 40000
PER_LAYER_SCAN = T
PER_LAYER_MAXITER = 10
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


def kernel_ms(run, frags, launches: int) -> tuple:
    """Device ms per launch of the kernels whose names hold each of
    ``frags``, from one eager run() under torch.profiler after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels, _ = device_busy(prof, "a timing by kernel name")
    return tuple(sum(e.time_range.end - e.time_range.start for e in kernels if f in e.name)
                 / launches / 1e3 for f in frags)


def bound(nbytes: float, ops: float, dtype_name: str) -> dict:
    """The benchmark's bound (``portbench.counts.bound_s``: the bytes moved
    over the memory rate or the operations over the peak rate for the
    inputs' type, whichever is larger) in ms, and which of the two it is."""
    from portbench import counts

    by_bytes, by_ops = counts.bound_s(nbytes, 0.0, dtype_name), counts.bound_s(0.0, ops,
                                                                               dtype_name)
    return {"bound_ms": max(by_bytes, by_ops) * 1e3,
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


def group_inputs(g, dxs, dtaps, masks, inmask, wd, wr) -> tuple:
    """K2-wf's arguments for the wavefront group g on the plain chain's
    cotangents: dxs[j] is that of layer j's output before its tap's, dtaps
    the tap cotangents (the last layer's is the start of the chain)."""
    js = range(g.j0, g.j0 + len(g.dils))
    return (dxs[js[-1]], [dtaps.get(j) if j != LAYERS - 1 else None for j in js],
            [masks[j] for j in js], masks[g.j0 - 1] if g.j0 else inmask,
            wd[g.j0:js[-1] + 1], wr[g.j0:js[-1] + 1])


def k2_chain(args, g, layer, rows: int, window=None):
    """The single-layer K2 launches (``layer``) that the group g replaces, on
    K2-wf's arguments ``args``."""
    dxn, gtaps, gmasks, in_m, gwd, gwr = args
    for j in range(len(g.dils) - 1, -1, -1):
        dxn = layer(dxn, gtaps[j], gmasks[j], gmasks[j - 1] if j else in_m,
                    gwd[j], gwr[j], g.dils[j], rows, window)
    return dxn


def wavefront_groups(dils, rows: int, itemsize: int) -> list:
    """The groups of the wavefront plan that run as one K2-wf launch."""
    from audio_style_transfer_tpu_torch.ops import chain

    return [g for g in chain.plan_bwd_groups(dils, rows, itemsize) if g.splits is not None]


def wavefront_launches(rows: int) -> tuple[int, int]:
    """(K2-wf, K2) launches of one bf16 trunk backward with the wavefront on
    at these clip rows, from the plan ``trunk_backward`` follows."""
    from audio_style_transfer_tpu_torch.ops import chain

    plan = chain.plan_bwd_groups(tuple(2 ** (k % 10) for k in range(LAYERS)), rows, 2)
    groups = sum(g.splits is not None for g in plan)
    return groups, len(plan) - groups


def chain_check(label: str, weights, x0, dtaps: dict, window, tol: float,
                clip_rows: int | None = None, wavefront: bool = True):
    """K1 and K2 over the 30 layers on x0 [clips * clip_rows, C] (one clip
    of x0's rows when ``clip_rows`` is None), with the valid window
    ``window`` or None, layer by layer on the plain chain's own inputs, masks
    and cotangents; then, with ``wavefront``, K2-wf on every group of the
    wavefront plan at these rows, against its plain version and bit for bit
    against the K2 launches it replaces (bf16: the tensor-core kernels;
    float32: the FMA kernels), with the same window. Returns (K1 max|d|, K2
    max|d|, K2-wf max|d| or None without a group, the plain chain's first
    ten outputs)."""
    import torch

    from audio_style_transfer_tpu_torch.ops import chain

    wd, bd, wr, br = weights
    rows = clip_rows or x0.shape[0]
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
    dx, k2_err, dxs = dtaps[LAYERS - 1], 0.0, {}
    for j in range(LAYERS - 1, -1, -1):
        dxs[j] = dx
        dtap = dtaps.get(j) if j != LAYERS - 1 else None
        in_m = masks[j - 1] if j > 0 else inmask
        dx_p = chain.layer_bwd_plain(dx, dtap, masks[j], in_m, wd[j], wr[j], dils[j], rows, window)
        abs_err, rel = rel_err(
            chain.layer_bwd(dx, dtap, masks[j], in_m, wd[j], wr[j], dils[j], rows, window), dx_p)
        if rel > tol:
            raise AssertionError(f"K2 layer {j}, {rows} rows, {label}: rel err {rel:.3e} > {tol}")
        k2_err = max(k2_err, abs_err)
        dx = dx_p
    groups = wavefront_groups(dils, rows, x0.element_size()) if wavefront else []
    wf_err = None
    for g in groups:
        args = group_inputs(g, dxs, dtaps, masks, inmask, wd, wr)
        got = chain.group_bwd(*args, g, rows, window)
        abs_err, rel = rel_err(got, chain.group_bwd_plain(*args, g.dils, rows, g.tile, g.splits,
                                                          window))
        if rel > tol or not torch.equal(got, k2_chain(args, g, chain.layer_bwd, rows, window)):
            raise AssertionError(f"K2-wf group at layer {g.j0}, {rows} rows, {label}: rel err "
                                 f"{rel:.3e}, or not the K2 launches bit for bit")
        wf_err = max(wf_err or 0.0, abs_err)
    zeros = "" if window is None else ", masked rows zero with a zero bit 0"
    wf = (f"; K2-wf: max|d| {wf_err:.3e} over {len(groups)} groups at tile {groups[0].tile}, "
          f"equal to the K2 launches bit for bit" if groups else
          "; no wavefront group" if wavefront else "")
    where = f"{rows} rows" if rows == x0.shape[0] else f"{x0.shape[0] // rows} x {rows} rows"
    print(f"  K1 at {where}, {label}: max|d| {k1_err:.3e} over 30 layers (tol rel {tol:.0e}), "
          f"mask bytes differing <= {k1_share:.2e}{zeros} ok; K2: max|d| {k2_err:.3e}{wf} ok")
    return k1_err, k2_err, wf_err, outs


def block_check(label: str, weights, x0, window, tol: float, seed: int = 2):
    """K7f and K7b over the 30 layers at x0's row count (one clip), with the
    valid window ``window`` or None, layer by layer on the plain block
    chain's own inputs. K7f against its plain version, zero outside the
    window, and equal bit for bit to K1's output (the same code with the
    mask bytes compiled out). K7b on a cotangent drawn per layer against its
    plain version fed K1's gate (bit 1 of its mask bytes, whose flips against
    the plain gate are held to MASK_TOL here): a y within rounding of zero
    that flips would move its neighbourhood's cotangent by about its own
    size. Returns (K7f max|d|, K7b max|d|)."""
    import torch

    from audio_style_transfer_tpu_torch.ops import chain, encoder

    wd, bd, wr, br = weights
    rows, dev, dt = x0.shape[0], x0.device, x0.dtype
    lo, hi = chain.clamp_window(window, rows)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dils = tuple(2 ** (k % 10) for k in range(LAYERS))
    cur, f_err, b_err, gate_share = x0, 0.0, 0.0, 0.0
    for j, d in enumerate(dils):
        w = (wd[j], bd[j], wr[j], br[j], d, rows)
        out_p = encoder.block_fwd_plain(cur, *w, window)
        out_k = encoder.block_fwd(cur, *w, window)
        out_1, m_1, _ = chain.layer_fwd(cur, *w, valid_window=window)
        _, m_p, _ = chain.layer_fwd_plain(cur, *w, valid_window=window)
        share = float((((m_1 >> 1) & 1) != ((m_p >> 1) & 1)).float().mean())
        abs_err, rel = rel_err(out_k, out_p)
        if (rel > tol or share > MASK_TOL or not torch.equal(out_k, out_1)
                or bool(out_k[:lo].any()) or bool(out_k[hi:].any())):
            raise AssertionError(f"K7f layer {j}, {rows} rows, {label}: rel err {rel:.3e}, "
                                 f"{share:.2e} of K1's gate bits differ, not K1's output, or a "
                                 f"masked row is not zero")
        f_err, gate_share = max(f_err, abs_err), max(gate_share, share)
        g = (torch.randn((rows, C), generator=gen, device=dev) * 1e-3).to(dt)
        want = chain.layer_bwd_plain(g, None, m_1, (cur > 0).to(torch.uint8), wd[j], wr[j], d,
                                     rows, window)
        abs_err, rel = rel_err(encoder.block_bwd(cur, g, wd[j], bd[j], wr[j], d, rows, window),
                               want)
        if rel > tol:
            raise AssertionError(f"K7b layer {j}, {rows} rows, {label}: rel err {rel:.3e} > {tol}")
        b_err = max(b_err, abs_err)
        cur = out_p
        del out_p, out_k, out_1, m_1, m_p, g, want
    zeros = "" if window is None else ", masked rows zero"
    print(f"  K7f at {rows} rows, {label}: max|d| {f_err:.3e} over 30 layers (tol rel "
          f"{tol:.0e}), K1's output bit for bit{zeros}, K1's gate bits against the plain gate "
          f"differing <= {gate_share:.2e}; K7b: max|d| {b_err:.3e} (plain version with K1's "
          f"gate) ok")
    return f_err, b_err


def scan_cases(samples: int, window: int) -> tuple:
    """(halo-extended rows, radius, the edge windows' valid windows, t_valid,
    t_total) of the exact scan of a ``samples``-long clip in ``window``-sample
    windows: the geometry transfer_exact gives the trunk."""
    from audio_style_transfer_tpu_torch.models.wavenet_ae import WaveNetAEConfig
    from audio_style_transfer_tpu_torch.parallel import halo
    from audio_style_transfer_tpu_torch.transfer.losses import LossSpec

    t_valid = (samples // 512) * 512
    t_total = -(-t_valid // window) * window
    scan = halo._Scan(WaveNetAEConfig(), LossSpec(), t_total, window, t_valid)
    return scan.w_ext, scan.radius, [scan.valid_window(i) for i in scan.edge], t_valid, t_total


def exact_shapes_phase(dtype_name: str, params, dev) -> dict:
    """The kernels against their plain versions at the shapes the exact
    long-form runs give them. K1, K2 and K2-wf (chain_check) on the chained
    scan's halo-extended window (its two edge windows masked, a middle one
    not) and on the single window's whole clip; K5 and K6 on the scan's
    cropped ten-tap gram and the single window's; K7f and K7b (block_check)
    on the per-layer scan's halo-extended window, its two edge windows and a
    middle one. Returns the largest max|d| per kernel."""
    import torch

    from audio_style_transfer_tpu_torch.ops import chain, gram

    dt = getattr(torch, dtype_name)
    tol = TOL[dtype_name]
    wd, bd, wr, br = chain.stack_trunk_weights(params, LAYERS)
    weights = (wd.to(dev, dt).contiguous(), bd.to(dev, torch.float32).contiguous(),
               wr.to(dev, dt).contiguous(), br.to(dev, torch.float32).contiguous())
    w_ext, radius, edges, _, _ = scan_cases(EXACT_SAMPLES, SCAN_WINDOW)
    one_window = (EXACT_SAMPLES // 4096) * 4096
    cases = (  # rows, valid window, rows cropped each side for the gram (None: no gram)
        (w_ext, edges[0], radius),  # the scan's first window
        *((w_ext, vw, None) for vw in edges[1:]),  # its last
        (w_ext, None, None),  # a middle window
        (one_window, None, 0),  # the single window
    )
    print(f"[exact shapes {dtype_name}] scan windows of {w_ext} rows (radius {radius}, edge "
          f"windows {edges}), one window of {one_window} rows")
    errs = {k: 0.0 for k in ("K1", "K2", "K2wf", "K5", "K6", "K7f", "K7b")}
    gen = torch.Generator(device=dev).manual_seed(1)
    for rows, window, crop in cases:
        x0 = (torch.randn((rows, C), generator=gen, device=dev) * 0.5).to(dt)
        dtaps = {j: (torch.randn((rows, C), generator=gen, device=dev) * 1e-3).to(dt)
                 for j in EMIT}
        label = "no window" if window is None else f"the valid window {window}"
        k1, k2, wf, outs = chain_check(label, weights, x0, dtaps, window, tol)
        errs["K1"], errs["K2"] = max(errs["K1"], k1), max(errs["K2"], k2)
        errs["K2wf"] = max(errs["K2wf"], wf or 0.0)
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
    w_ext, radius, edges, _, _ = scan_cases(PER_LAYER_SAMPLES, PER_LAYER_SCAN)
    print(f"[exact shapes {dtype_name}] per-layer scan windows of {w_ext} rows (radius {radius}, "
          f"edge windows {edges})")
    for window in (*edges, None):
        x0 = (torch.randn((w_ext, C), generator=gen, device=dev) * 0.5).to(dt)
        label = "no window" if window is None else f"the valid window {window}"
        k7f, k7b = block_check(label, weights, x0, window, tol)
        errs["K7f"], errs["K7b"] = max(errs["K7f"], k7f), max(errs["K7b"], k7b)
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

    # K1 and K7f, layer by layer on the plain chain's own inputs. K7f is
    # K1's code with the mask bytes compiled out (tensor cores in bfloat16,
    # FMA in float32): its output equals K1's bit for bit.
    xs, masks, kmasks, inmask = [x0], [], [], None
    k1_err, k7f_err, mask_share = 0.0, 0.0, 0.0
    for j, d in enumerate(dils):
        out_p, m_p, im_p = chain.layer_fwd_plain(xs[-1], wd[j], bd[j], wr[j], br[j], d, T,
                                                 want_inmask=(j == 0))
        out_k, m_k, im_k = chain.layer_fwd(xs[-1], wd[j], bd[j], wr[j], br[j], d, T,
                                           want_inmask=(j == 0))
        abs_err, rel = rel_err(out_k, out_p)
        if rel > tol:
            raise AssertionError(f"K1 layer {j}: rel err {rel:.3e} > {tol}")
        k1_err = max(k1_err, abs_err)
        out_7 = encoder.block_fwd(xs[-1], wd[j], bd[j], wr[j], br[j], d, T)
        abs_err, rel = rel_err(out_7, out_p)
        if rel > tol or not torch.equal(out_7, out_k):
            raise AssertionError(f"K7f layer {j}: rel err {rel:.3e} > {tol}, or not K1's output")
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
        kmasks.append(m_k)
    print(f"  K1 taps: max|d| {k1_err:.3e} over 30 layers (tol rel {tol:.0e}) ok; "
          f"mask bytes differing <= {mask_share:.2e} (tol {MASK_TOL:.0e}) ok")
    print(f"  K7f out: max|d| {k7f_err:.3e} over 30 layers (tol rel {tol:.0e}), equal to K1's "
          f"output bit for bit ok")

    # K2 and K7b, layer by layer on the plain chain's cotangents (and masks).
    dtaps = {j: (torch.randn((T, C), generator=gen, device=dev) * 1e-3).to(dt) for j in EMIT}
    dx = dtaps[LAYERS - 1]
    k2_err, k7b_err = 0.0, 0.0
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
        gs[j] = dx if dtap is None else dx + dtap  # layer j's output cotangent
        # K7b recomputes its gate y > 0 from x with K1's dilated-conv code
        # (the tensor-core K1's in bfloat16, the FMA K1's in float32), so its
        # gate is bit 1 of that kernel's mask bytes (kmasks), whose flips
        # against the plain gate are bounded by MASK_TOL above. Its plain
        # version here takes that gate: a y within rounding of zero that
        # flips would move the cotangent of its neighbourhood by about its
        # own size. K2 fed that gate and x > 0 runs K7b's phase 2 after the
        # same g @ Wr^T product: equal bit for bit, so K7b's gate is K1's bit 1.
        in_relu = (xs[j] > 0).to(torch.uint8)
        want = chain.layer_bwd_plain(gs[j], None, kmasks[j], in_relu, wd[j], wr[j], dils[j], T)
        dx_7 = encoder.block_bwd(xs[j], gs[j], wd[j], bd[j], wr[j], dils[j], T)
        abs_err, rel = rel_err(dx_7, want)
        if rel > tol:
            raise AssertionError(f"K7b layer {j}: rel err {rel:.3e} > {tol}")
        k7b_err = max(k7b_err, abs_err)
        if not torch.equal(dx_7, chain.layer_bwd(gs[j], None, kmasks[j], in_relu, wd[j],
                                                 wr[j], dils[j], T)):
            raise AssertionError(f"K7b layer {j} differs from K2 fed K1's gate: its recomputed "
                                 f"gate is not K1's bit 1")
        dx = dx_p
    print(f"  K2 dx: max|d| {k2_err:.3e} over 30 layers (tol rel {tol:.0e}) ok")
    print(f"  K7b dx: max|d| {k7b_err:.3e} over 30 layers (tol rel {tol:.0e}; plain version "
          f"with K1's gate) ok; equal to K2 fed that gate bit for bit ok")

    # K2-wf on every group of the wavefront plan, on the plain chain's
    # cotangents and masks: against its plain version and bit for bit against
    # the K2 launches it replaces (in bfloat16 the tensor-core kernels, in
    # float32 the FMA kernels).
    groups = wavefront_groups(dils, T, x0.element_size())
    if not groups:
        raise AssertionError("the wavefront plan holds no group at the full geometry")

    def group_args(g):
        return group_inputs(g, dxs, dtaps, masks, inmask, wd, wr)

    wf_err = 0.0
    for g in groups:
        got = chain.group_bwd(*group_args(g), g, T)
        want = chain.group_bwd_plain(*group_args(g), g.dils, T, g.tile, g.splits)
        abs_err, rel = rel_err(got, want)
        if rel > tol:
            raise AssertionError(f"K2-wf group at layer {g.j0}: rel err {rel:.3e} > {tol}")
        wf_err = max(wf_err, abs_err)
        if not torch.equal(got, k2_chain(group_args(g), g, chain.layer_bwd, T)):
            raise AssertionError(f"K2-wf group at layer {g.j0} differs from the K2 launches")
    print(f"  K2-wf dx: max|d| {wf_err:.3e} over {len(groups)} groups of dils "
          f"{groups[0].dils} at tile {groups[0].tile} (tol rel {tol:.0e}) ok; equal to the K2 "
          f"launches it replaces bit for bit")

    # K1, K2 and K2-wf with a valid window that cuts tiles; then K7f and K7b.
    k1w_err, k2w_err, wfw_err, _ = chain_check(f"the valid window {WINDOW}",
                                               (wd, bd, wr, br), x0, dtaps, WINDOW, tol)
    k7fw_err, k7bw_err = block_check(f"the valid window {WINDOW}", (wd, bd, wr, br), x0, WINDOW,
                                     tol)

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

    def blocks(block, backward: bool, window=None):
        def run():
            for j, d in enumerate(dils):
                if backward:
                    block(xs[j], gs[j], wd[j], bd[j], wr[j], d, T, window)
                else:
                    block(xs[j], wd[j], bd[j], wr[j], br[j], d, T, window)
        return run

    # K1, K2, K7f, K7b, K5 and K6 are timed as a replayed CUDA graph of their
    # launches (the kernels' own time) and, beside it, as eager wrapper calls
    # (what a caller that enqueues them one by one sees: the host's time per
    # call where that exceeds the kernel's).
    times = {
        "K1": (cuda_ms(fwd(chain.layer_fwd), graph=True) / LAYERS,
               cuda_ms(fwd(chain.layer_fwd_plain)) / LAYERS),
        "K2": (cuda_ms(bwd(chain.layer_bwd), graph=True) / LAYERS,
               cuda_ms(bwd(chain.layer_bwd_plain)) / LAYERS),
        "K7f": (cuda_ms(blocks(encoder.block_fwd, False), graph=True) / LAYERS,
                cuda_ms(blocks(encoder.block_fwd_plain, False)) / LAYERS),
        "K7b": (cuda_ms(blocks(encoder.block_bwd, True), graph=True) / LAYERS,
                cuda_ms(blocks(encoder.block_bwd_plain, True)) / LAYERS),
    }
    eager_ms = {"K1": cuda_ms(fwd(chain.layer_fwd)) / LAYERS,
                "K2": cuda_ms(bwd(chain.layer_bwd)) / LAYERS,
                "K7f": cuda_ms(blocks(encoder.block_fwd, False)) / LAYERS,
                "K7b": cuda_ms(blocks(encoder.block_bwd, True)) / LAYERS}
    # The windowed kernels between two timings of the unwindowed ones (the
    # same launches with two more integers; the same bytes and bound).
    windowed_ms = {}
    for k, run in (("K1", lambda w: fwd(chain.layer_fwd, w)),
                   ("K2", lambda w: bwd(chain.layer_bwd, w)),
                   ("K7f", lambda w: blocks(encoder.block_fwd, False, w)),
                   ("K7b", lambda w: blocks(encoder.block_bwd, True, w))):
        ms = [cuda_ms(run(w), graph=True) / LAYERS for w in (None, WINDOW, WINDOW, None)]
        windowed_ms[k] = min(ms[1:3])
        print(f"  {k} with the valid window, time per launch: {ms[1]:.4f}, {ms[2]:.4f} ms between "
              f"{ms[0]:.4f} and {ms[3]:.4f} ms without a window")
    ng = len(groups)
    ms = [cuda_ms(lambda: [chain.group_bwd(*group_args(g), g, T, w) for g in groups],
                  graph=True) / ng
          for w in (None, WINDOW, WINDOW, None)]
    windowed_ms["K2wf"] = min(ms[1:3])
    print(f"  K2-wf with the valid window, time per group: {ms[1]:.4f}, {ms[2]:.4f} ms between "
          f"{ms[0]:.4f} and {ms[3]:.4f} ms without a window")
    # K2 and K7b phase by phase: each phase's kernel time under torch.profiler.
    for k, run, frags in (("K2", bwd(chain.layer_bwd), ("trunk_bwd_dy", "trunk_bwd_dx")),
                          ("K7b", blocks(encoder.block_bwd, True),
                           ("encoder_bwd_dy", "trunk_bwd_dx"))):
        dy_ms, dx_ms = kernel_ms(run, frags, LAYERS)
        print(f"  {k} time per launch by phase (torch.profiler): dy {dy_ms:.4f} ms, "
              f"dx {dx_ms:.4f} ms")
    # K2-wf as a replayed CUDA graph beside the eager call, and the K2
    # launches it replaces in one graph; then K2-wf again, so that a drift of
    # the card's clock shows.
    def groups_run(fn):
        return lambda: [fn(*group_args(g), g, T) for g in groups]

    wf_ms = [cuda_ms(groups_run(chain.group_bwd), graph=True) / ng]
    times["K2wf"] = (
        wf_ms[0],
        cuda_ms(lambda: [chain.group_bwd_plain(*group_args(g), g.dils, T, g.tile, g.splits)
                         for g in groups]) / ng)
    eager_ms["K2wf"] = cuda_ms(groups_run(chain.group_bwd)) / ng
    k2_ms = cuda_ms(lambda: [k2_chain(group_args(g), g, chain.layer_bwd, T) for g in groups],
                    graph=True) / ng
    wf_ms.append(cuda_ms(groups_run(chain.group_bwd), graph=True) / ng)
    kg = len(groups[0].dils)
    print(f"  K2-wf time per group of {kg} layers: {wf_ms[0]:.4f} ms, again {wf_ms[1]:.4f} ms "
          f"(graph; {eager_ms['K2wf']:.4f} ms per eager call), against {k2_ms:.4f} ms for the "
          f"{kg} K2 launches it replaces (layer_bwd, one graph): "
          f"{'faster' if min(wf_ms) < k2_ms else 'slower'} by {abs(k2_ms - min(wf_ms)):.4f} ms")
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
        print(f"  {k} time per launch: kernel {ms:.4f} ms{eager}, plain {plain_ms:.4f} ms{lib}")
    errs.update({"K1": k1_err, "K2": k2_err, "K2wf": wf_err, "K7f": k7f_err, "K7b": k7b_err})
    windowed = {k: {"windowed_max_abs_err": err, "windowed_ms": windowed_ms[k]}
                for k, err in (("K1", k1w_err), ("K2", k2w_err), ("K7f", k7fw_err),
                               ("K7b", k7bw_err), ("K2wf", wfw_err))}
    # K2-wf's yardstick: the K2 launches it replaces, in one graph.
    windowed["K2wf"].update(k2_launches_ms=k2_ms)

    # Bounds from these shapes. A product is one [T, C] x [C, C] matrix
    # product; an activation or cotangent array is T * C elements.
    item = x0.element_size()
    act, product, weights = T * C * item, 2.0 * T * C * C, 4 * C * C * item
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
                    library_ms=library.get(k), **bounds[k],
                    **windowed.get(k, {})) for k in errs}


# K1 and K2 by phase at the engine's T and at the exact cells' clip.
TRUNK_PHASE_ROWS = (T, 237568)


def trunk_phase_times(params, dev) -> dict:
    """K1 and K2's two phases in bfloat16 at TRUNK_PHASE_ROWS: each kernel's
    device time per launch from torch.profiler over a trunk pass (30 layers
    forward, then 30 backward, each with a tap cotangent), against
    portbench/counts.py's per-launch bounds (K2's with a tap)."""
    import torch

    from audio_style_transfer_tpu_torch.ops import chain
    from portbench import counts

    dt = torch.bfloat16
    dils = tuple(2 ** (k % 10) for k in range(LAYERS))
    wd, bd, wr, br = chain.stack_trunk_weights(params, LAYERS)
    wd, wr = wd.to(dev, dt).contiguous(), wr.to(dev, dt).contiguous()
    bd, br = bd.to(dev, torch.float32).contiguous(), br.to(dev, torch.float32).contiguous()
    out = {}
    for rows in TRUNK_PHASE_ROWS:
        gen = torch.Generator(device=dev).manual_seed(rows)
        xs = [(torch.randn((rows, C), generator=gen, device=dev) * 0.5).to(dt)]
        g = (torch.randn((rows, C), generator=gen, device=dev) * 1e-3).to(dt)
        masks = []
        for j, d in enumerate(dils):
            o, m, _ = chain.layer_fwd(xs[-1], wd[j], bd[j], wr[j], br[j], d, rows)
            xs.append(o)
            masks.append(m)
        inmask = (xs[0] > 0).to(torch.uint8)

        def run():
            for j, d in enumerate(dils):
                chain.layer_fwd(xs[j], wd[j], bd[j], wr[j], br[j], d, rows)
            for j in range(LAYERS - 1, -1, -1):
                chain.layer_bwd(g, g, masks[j], masks[j - 1] if j else inmask, wd[j], wr[j],
                                dils[j], rows)

        k1_ms, dy_ms, dx_ms = kernel_ms(run, ("trunk_fwd_mma", "trunk_bwd_dy_mma",
                                              "trunk_bwd_dx_mma"), LAYERS)
        b1 = counts.bound_s(*counts.k1(rows, C, "bfloat16"), "bfloat16") * 1e3
        b2 = counts.bound_s(*counts.k2(rows, C, "bfloat16", True), "bfloat16") * 1e3
        print(f"[trunk phases bf16, {rows} rows] per launch (torch.profiler): K1 {k1_ms:.4f} ms "
              f"against its bound {b1:.4f} ms ({100 * b1 / k1_ms:.1f}%); K2 dy {dy_ms:.4f} + dx "
              f"{dx_ms:.4f} = {dy_ms + dx_ms:.4f} ms against {b2:.4f} ms "
              f"({100 * b2 / (dy_ms + dx_ms):.1f}%)")
        out[rows] = {"k1_ms": k1_ms, "k1_bound_ms": b1, "k2_dy_ms": dy_ms, "k2_dx_ms": dx_ms,
                     "k2_bound_ms": b2}
        del xs, masks, g, inmask
        torch.cuda.empty_cache()
    return out


# The per-layer (Gatys) grams at the benchmark's 15 s clip, one window: rows
# and style taps of the full stack. K8f against the float64 gram, relative
# L2 (the plain float32 route, one product over all the rows, is some 1e-4
# off); K8b against autograd of the plain route: bf16 rounds nearly the same
# float32 sums once.
LAYER_GRAM_ROWS = 237568
LAYER_GRAM_FWD_TOL = 1e-5
LAYER_GRAM_BWD_TOL = {"float32": 1e-5, "bfloat16": 1e-3}

# The all-pairs grams K5 / K6 at the same clip, one window: K5 against the
# float64 gram (bf16: a warp adds each 32-row stage's tensor-core sums into a
# float32 sum; float32: a thread adds a chunk's rows in ascending order,
# 3712 products at L=30) and the bf16 K5 against the float32 K5 of the same
# taps; K6 against its plain composition (float32 sums either way, rounded
# once to the taps' dtype).
PAIR_GRAM_ROWS = 237568
PAIR_GRAM_FWD_TOL = 1e-5
PAIR_GRAM_CROSS_TOL = 2e-5
PAIR_GRAM_BWD_TOL = {"float32": 1e-5, "bfloat16": 1e-3}

# The decoder block's epilogues at the training step's shape: 32 x 6144 rows,
# 12 hop frames a clip, width 512 (the gate's y is [rows, 1024]), skip 256.
DECODER_SHAPE = (32, 6144, 12)
DECODER_M, DECODER_SKIP = 512, 256
# Gate backward's float32 sums (dc, the biases' gradients) against the plain
# version's: the same rounded dz summed in another order; over the largest.
DECODER_SUM_TOL = 1e-4


def decoder_kernel_phase(dtype_name: str, dev) -> dict:
    """The decoder block's four epilogue kernels (ops/decoder.py) at the
    training step's shape against their plain versions on the card: the
    forwards bit for bit, the gate backward's dz within one rounding of the
    tensors' type, its dc and the biases' column sums within
    DECODER_SUM_TOL; each kernel and its plain version timed as a replayed
    CUDA graph. Bound: the bytes each must move (its arithmetic is a few
    operations an element) over the memory rate. dz: the kernel's 1 - tanh^2
    is one fused multiply-add where the plain version rounds twice, so bf16
    holds element by element and float32 by TOL over the largest entry."""
    import torch

    from audio_style_transfer_tpu_torch.ops import decoder

    dt = getattr(torch, dtype_name)
    b, t, frames = DECODER_SHAPE
    m, sk, rows = DECODER_M, DECODER_SKIP, b * t
    gen = torch.Generator(device=dev).manual_seed(19)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dt)

    y, c, dg = rand(b, t, 2 * m, scale=2.0), rand(b, frames, 2 * m), rand(b, t, m)
    bd, bc = rand(2 * m, scale=0.3), rand(2 * m, scale=0.3)
    l, r, s, k = rand(b, t, m), rand(b, t, m), rand(b, t, sk), rand(b, t, sk)
    br, bs = rand(m, scale=0.3), rand(sk, scale=0.3)
    item = y.element_size()
    cases = {  # name: (kernel, plain version, bytes it must move)
        "gate_fwd": (lambda: decoder.gate_fwd(y, c, bd, bc),
                     lambda: decoder.gate_fwd_plain(y, c, bd, bc),
                     item * (rows * 3 * m + b * frames * 2 * m + 4 * m)),
        "gate_bwd": (lambda: decoder.gate_bwd(y, c, bd, bc, dg),
                     lambda: decoder.gate_bwd_plain(y, c, bd, bc, dg),
                     item * (rows * 5 * m + b * frames * 2 * m + 4 * m) + 4 * b * frames * 2 * m),
        "residual_fwd": (lambda: decoder.residual_fwd(l, s, r, k, br, bs),
                         lambda: decoder.residual_fwd_plain(l, s, r, k, br, bs),
                         item * (rows * 3 * (m + sk) + m + sk)),
        "residual_bwd": (lambda: decoder.residual_bwd(l, s),
                         lambda: decoder.residual_bwd_plain(l, s),
                         item * rows * (m + sk) + 4 * (m + sk)),
    }
    out = {}
    print(f"[decoder kernels {dtype_name}] {b} x {t} rows, {frames} frames a clip, m {m}, "
          f"skip {sk}")
    for name, (kernel, plain, nbytes) in cases.items():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        if name.endswith("_fwd"):
            pairs = [(got, want)] if name == "gate_fwd" else list(zip(got, want))
            if not all(torch.equal(a, w) for a, w in pairs):
                diff = [float((a.float() - w.float()).abs().max()) for a, w in pairs]
                raise AssertionError(f"[decoder kernels {dtype_name}] {name}: not bit for bit "
                                     f"its plain version (max|d| {diff})")
            err, note = 0.0, "bit for bit"
        elif name == "gate_bwd":
            (dz, dc), (dz_p, dc_p) = got, want
            # One bf16 step is at most 2^-7 of the value; float32: a few of its steps.
            dz_err, dz_rel = rel_err(dz, dz_p)
            dz_share = float((dz != dz_p).float().mean())
            far = 0
            if dt == torch.bfloat16:  # beyond one bf16 step, at most 2^-7 of the value
                far = int(((dz.float() - dz_p.float()).abs() > 2.0 ** -7 * dz_p.float().abs())
                          .sum())
            sums = [rel_err(dc, dc_p)[1], rel_err(dc.sum((0, 1)), dc_p.sum((0, 1)))[1]]
            if far or dz_rel > TOL[dtype_name] or max(sums) > DECODER_SUM_TOL:
                raise AssertionError(f"[decoder kernels {dtype_name}] gate_bwd: dz rel {dz_rel}, "
                                     f"{far} beyond one bf16 step; dc / db rel {sums}")
            err = dz_err
            note = (f"dz {dz_share:.2e} of elements differ (max|d| {dz_err:.3e}, rel "
                    f"{dz_rel:.2e}, tol {TOL[dtype_name]:.0e}; bf16: none beyond one step); dc "
                    f"rel {sums[0]:.2e}, db rel {sums[1]:.2e} (tol {DECODER_SUM_TOL:.0e})")
        else:
            sums = [rel_err(a, w)[1] for a, w in zip(got, want)]
            if max(sums) > DECODER_SUM_TOL:
                raise AssertionError(f"[decoder kernels {dtype_name}] residual_bwd: rel {sums}")
            err = max(rel_err(a, w)[0] for a, w in zip(got, want))
            note = f"db_res rel {sums[0]:.2e}, db_skip rel {sums[1]:.2e}"
        del got, want
        ms = cuda_ms(kernel, graph=True)
        plain_ms = cuda_ms(plain, graph=True)
        bnd = bound(nbytes, 0.0, dtype_name)
        out[name] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                         library_ms=None, **bnd)
        print(f"  {name}: {note} ok; kernel {ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
              f"({nbytes / 1e6:.0f} MB, {bnd['bound_ms'] / ms:.1%} of it), plain {plain_ms:.4f} ms")
        torch.cuda.empty_cache()
    return out


# The pack's cases at the training step's rows, F=3 causal (ops/conv.py::taps_pack): the
# decoder's dilated conv input x and its output's cotangent g, packed with the taps negated for
# the input gradient; dilations 1 and 512, the decoder's shortest and longest.
TAPS_PACK_CASES = {  # name: (channels, dilation, negated)
    "x d=1": (512, 1, False), "x d=512": (512, 512, False),
    "g d=1": (1024, 1, True), "g d=512": (1024, 512, True),
}


def taps_pack_phase(dev) -> dict:
    """The merged-taps pack kernel (csrc/conv.cu) at the training step's 32 x
    6144 rows in bfloat16 against the plain route it replaced (``F.pad`` and
    ``torch.cat`` of the shifted views): bit for bit; each timed as a
    replayed CUDA graph beside the plain route and its bound (one read of the
    input, one write of the operand, over the memory rate). Per step, the
    decoder's share: 60 x packs and 30 g packs, at the mean of the two
    dilations."""
    import torch

    from audio_style_transfer_tpu_torch.ops import conv

    b, t = TRAIN_SHAPE
    gen = torch.Generator(device=dev).manual_seed(22)
    out = {}
    print(f"[taps pack] {b} x {t} rows, F=3 causal, bfloat16")
    for name, (c, d, negated) in TAPS_PACK_CASES.items():
        offsets = conv._offsets(3, d, True)
        if negated:
            offsets = [-o for o in offsets]
        x = torch.randn((b, t, c), generator=gen, device=dev).to(torch.bfloat16)

        def kernel():
            return conv.taps_pack(x, offsets)

        def plain():
            return torch.cat(conv._shifted_by(x, offsets), dim=-1)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"[taps pack] {name}: not bit for bit the plain route")
        del got, want
        ms = cuda_ms(kernel, graph=True)
        plain_ms = cuda_ms(plain, graph=True)
        nbytes = x.numel() * x.element_size() * (1 + len(offsets))
        bnd = bound(nbytes, 0.0, "bfloat16")
        out[f"TP {name}"] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=0.0,
                                 library_ms=None, **bnd)
        print(f"  {name} (C {c}, offsets {offsets}): bit for bit ok; kernel {ms:.4f} ms, bound "
              f"{bnd['bound_ms']:.4f} ms ({nbytes / 1e6:.0f} MB, {bnd['bound_ms'] / ms:.1%} of "
              f"it), plain {plain_ms:.4f} ms")
        del x
        torch.cuda.empty_cache()
    per_step = {key: 30 * sum((2 if n.startswith("x") else 1) * out[f"TP {n}"][key]
                              for n in TAPS_PACK_CASES) / 2
                for key in ("ms", "bound_ms", "plain_ms")}
    print(f"[taps pack] a training step's 90 decoder packs: kernel {per_step['ms']:.1f} ms, "
          f"bound {per_step['bound_ms']:.1f} ms, plain {per_step['plain_ms']:.1f} ms")
    return out


def layer_gram_kernel_phase(dtype_name: str, dev) -> dict:
    """K8f and K8b (ops/gram.py::layer_gram_fwd / layer_gram_bwd) at the 15 s
    clip's rows and the full stack's 30 taps against the plain route
    (``layer_gram_reference``: the taps concatenated, cast to float32 and
    multiplied; its autograd for the backward). K8f is held to the float64
    gram and must come closer to it than the plain route; K8b to the plain
    route's cotangents, for a float32 gradient (the exact path's). Each kernel
    and its plain version timed as a replayed CUDA graph; the plain
    backward's time is its graph of forward and backward less the forward's.
    Bounds from the benchmark's counts of the kernels' bytes and operations."""
    import torch

    from audio_style_transfer_tpu_torch.ops import gram
    from portbench import counts_layer_gram

    dt = getattr(torch, dtype_name)
    rows, nl = LAYER_GRAM_ROWS, LAYERS
    gen = torch.Generator(device=dev).manual_seed(23)
    taps = [torch.randn((1, rows, C), generator=gen, device=dev).to(dt) for _ in range(nl)]
    g = torch.randn((nl, C, C), generator=gen, device=dev) * 1e-3
    leaves = [tp.detach().requires_grad_(True) for tp in taps]

    def l2(a, b) -> float:
        a, b = a.double(), b.double()
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

    def plain_fwd():
        return gram.layer_gram_reference(*taps)

    def plain_fwd_bwd():
        return torch.autograd.grad(gram.layer_gram_reference(*leaves), leaves, g)

    print(f"[layer gram kernels {dtype_name}] {rows} rows, L={nl}, C={C}")
    got, plain = gram.layer_gram_fwd(*taps), plain_fwd()
    exact = torch.stack([tp[0].double().T @ tp[0].double() for tp in taps])
    fwd_rel, plain_rel = l2(got, exact), l2(plain, exact)
    fwd_err = float((got.double() - exact).abs().max())
    if fwd_rel > LAYER_GRAM_FWD_TOL or fwd_rel >= plain_rel:
        raise AssertionError(f"[layer gram kernels {dtype_name}] K8f: rel L2 {fwd_rel:.3e} to "
                             f"the float64 gram, the plain route {plain_rel:.3e}")
    print(f"  K8f: rel L2 {fwd_rel:.3e} to the float64 gram (tol {LAYER_GRAM_FWD_TOL:.0e}; "
          f"the plain route {plain_rel:.3e}, K8f to it {l2(got, plain):.3e}), max|d| "
          f"{fwd_err:.3e} ok")
    del got, plain, exact
    outs, want = gram.layer_gram_bwd(taps, g), plain_fwd_bwd()
    bwd_rel = max(l2(a, w) for a, w in zip(outs, want))
    bwd_err = max(float((a.float() - w.float()).abs().max()) for a, w in zip(outs, want))
    tol = LAYER_GRAM_BWD_TOL[dtype_name]
    if bwd_rel > tol or any(a.dtype != dt for a in outs):
        raise AssertionError(f"[layer gram kernels {dtype_name}] K8b: worst rel L2 "
                             f"{bwd_rel:.3e} to the plain route (tol {tol:.0e})")
    print(f"  K8b: worst rel L2 {bwd_rel:.3e} over {nl} cotangents to the plain route "
          f"(tol {tol:.0e}), max|d| {bwd_err:.3e} ok")
    del outs, want
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    plain_fwd_ms = cuda_ms(plain_fwd, graph=True)
    times = {
        "K8f": (cuda_ms(lambda: gram.layer_gram_fwd(*taps), graph=True), plain_fwd_ms,
                fwd_err, counts_layer_gram.k8f(rows, C, nl, dtype_name)),
        "K8b": (cuda_ms(lambda: gram.layer_gram_bwd(taps, g), graph=True),
                cuda_ms(plain_fwd_bwd, graph=True) - plain_fwd_ms,
                bwd_err, counts_layer_gram.k8b(rows, C, nl, dtype_name)),
    }
    out = {}
    for name, (ms, plain_ms, err, (nbytes, ops)) in times.items():
        bnd = bound(nbytes, ops, dtype_name)
        out[name] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                         library_ms=None, **bnd)
        print(f"  {name}: kernel {ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms by "
              f"{bnd['bound_by']} ({bnd['bound_ms'] / ms:.1%} of it), plain {plain_ms:.4f} ms")
    del taps, leaves
    torch.cuda.empty_cache()
    return out


def pair_gram_clip_phase(dev) -> dict:
    """K5 and K6 (ops/gram.py::pair_gram_fwd / pair_gram_bwd) at the 15 s
    clip's rows, at the full stack's 30 taps (the ``transfer_full_exact15s``
    cell) and the ten of stack 0 (the ``transfer_exact15s`` cell), in bf16
    (the tensor-core kernels) and in float32 (the FMA kernels). K5 is held to
    the float64 gram and run twice for equal bits, the bf16 K5 also to the
    float32 K5 of the same taps; K6 to its plain composition. Each kernel
    timed as a replayed CUDA graph, median of 20, against the benchmark's
    bound of its bytes and operations (``portbench/counts.py::k5`` / ``k6``)."""
    import torch

    from audio_style_transfer_tpu_torch.ops import gram
    from portbench import counts

    rows = PAIR_GRAM_ROWS
    gen = torch.Generator(device=dev).manual_seed(29)
    out = {}
    for nl in (LAYERS, len(STYLE)):
        base = [torch.randn((1, rows, C), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(nl)]
        h = torch.randn((1, nl, nl, C), generator=gen, device=dev) * 1e-3
        h = (h + h.transpose(1, 2)).contiguous()
        exact = []
        for c0 in range(0, C, 16):  # the float64 gram, 16 channels at a time
            e = torch.stack([tp[0, :, c0:c0 + 16].double() for tp in base])
            exact.append(torch.einsum("atc,btc->abc", e, e))
        exact = torch.cat(exact, dim=2)[None]
        grams = {}
        for dtype_name in ("bfloat16", "float32"):
            taps = [tp.to(getattr(torch, dtype_name)) for tp in base]
            tag = f"[pair gram clip {dtype_name}] {rows} rows, L={nl}"
            got = grams[dtype_name] = gram.pair_gram_fwd(*taps)
            if not torch.equal(got, gram.pair_gram_fwd(*taps)):
                raise AssertionError(f"{tag}: K5's two launches differ in their bits")
            fwd_rel = float(torch.linalg.vector_norm(got.double() - exact)
                            / torch.linalg.vector_norm(exact))
            fwd_err = float((got.double() - exact).abs().max())
            if fwd_rel > PAIR_GRAM_FWD_TOL:
                raise AssertionError(f"{tag}: K5 rel L2 {fwd_rel:.3e} to the float64 gram "
                                     f"(tol {PAIR_GRAM_FWD_TOL:.0e})")
            outs, want = gram.pair_gram_bwd(taps, h), gram.pair_gram_bwd_plain(taps, h)
            bwd_rel = max(float(torch.linalg.vector_norm(a.float() - w.float())
                                / torch.linalg.vector_norm(w.float()))
                          for a, w in zip(outs, want))
            bwd_err = max(float((a.float() - w.float()).abs().max()) for a, w in zip(outs, want))
            del outs, want
            tol = PAIR_GRAM_BWD_TOL[dtype_name]
            if bwd_rel > tol:
                raise AssertionError(f"{tag}: K6 worst rel L2 {bwd_rel:.3e} to the plain "
                                     f"composition (tol {tol:.0e})")
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            times = {"K5": (cuda_ms(lambda: gram.pair_gram_fwd(*taps), graph=True), fwd_err,
                            counts.k5(rows, C, nl, dtype_name)),
                     "K6": (cuda_ms(lambda: gram.pair_gram_bwd(taps, h), graph=True), bwd_err,
                            counts.k6(rows, C, nl, dtype_name))}
            print(f"{tag}: K5 rel L2 {fwd_rel:.3e} to the float64 gram, two launches equal bit "
                  f"for bit; K6 worst rel L2 {bwd_rel:.3e} to the plain composition ok")
            for name, (ms, err, (nbytes, ops)) in times.items():
                bnd = bound(nbytes, ops, dtype_name)
                out[f"{name} {dtype_name} {rows} L={nl}"] = dict(ms=ms, max_abs_err=err, **bnd)
                print(f"  {name}: kernel {ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms by "
                      f"{bnd['bound_by']} ({bnd['bound_ms'] / ms:.1%} of it)")
            del taps
        cross = float(torch.linalg.vector_norm(grams["bfloat16"] - grams["float32"])
                      / torch.linalg.vector_norm(grams["float32"]))
        if cross > PAIR_GRAM_CROSS_TOL:
            raise AssertionError(f"[pair gram clip] L={nl}: the bf16 K5 is {cross:.3e} from the "
                                 f"float32 K5 of the same taps (tol {PAIR_GRAM_CROSS_TOL:.0e})")
        print(f"[pair gram clip] L={nl}: the bf16 K5 (tensor cores) rel L2 {cross:.3e} to the "
              f"float32 K5 (FMA) of the same taps ok")
        del base, h, exact, grams
        torch.cuda.empty_cache()
    return out


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
    # Per loss+gradient evaluation the backward runs the plan's groups and
    # single layers (30 single layers with the wavefront off); K1 also runs
    # in the gradient-free passes (targets, OT taps, closing forwards).
    n_wf, n_k2 = wavefront_launches(T) if wavefront else (0, LAYERS)
    want = {"K2wf": n_wf * evals, "K2": n_k2 * evals}
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
    gram backward (K6, or K8b for the Gatys gram) and nothing else: one launch
    per evaluation that took a gradient, each after a forward (K5, K8f) of its
    own (the forward also runs in the gradient-free passes that make the
    targets)."""
    missing = [k for k in sorted(expected) if launches[k] == 0]
    extra = [k for k in KERNELS if k not in expected and launches[k] != 0]
    if missing or extra:
        raise AssertionError(f"{label}: kernels not launched {missing}, launched but not on "
                             f"this path {extra}: {launches}")
    fwd, bwd = ("K8f", "K8b") if "K8b" in expected else ("K5", "K6")
    if launches[bwd] != grad_evals or launches[fwd] < grad_evals:
        raise AssertionError(f"{label}: {bwd} {launches[bwd]} and {fwd} {launches[fwd]} launches "
                             f"for {grad_evals} evaluations that took a gradient")
    print(f"[{label}] launches {launches}: {sorted(expected)} all > 0, the rest 0; {bwd} == "
          f"{grad_evals} gradient evaluations <= {fwd} ok")


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
              band=None, weights=("--random_init",)):
    """The port's CLI, 3 epochs of transfer in ``precision`` on ``weights``
    (its arguments: seed-0 weights, or ``--ckpt_path <prefix>``); returns
    (launches, evals, wall seconds, final loss, the losses by epoch)."""
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
                "--precision", precision, "--fused", *weights, "--no_artifacts",
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
    return launches, evals, wall, losses[-1], losses


TF1_SLOT_LAYERS = ("ae_startconv", "ae_res_1")  # layers given optimizer slots in the bundle


def tf1_checkpoint_phase(dev, smi: str, ref: dict) -> dict:
    """`[tf1 checkpoint]`: the pretrained-weights path on a machine without
    TensorFlow. A full-size NSynth bundle in TF's layout (all 187 layers of
    ``init_params(0)``, ``<layer>/W`` as [1, F, Cin, Cout] and
    ``<layer>/biases``, with ``global_step`` and the Adam and EMA slots of
    two layers, which the converter skips), written by
    tools/tf1_bundle.py; the bundle read, ``convert_tf1_checkpoint``, the
    first ``load_pretrained`` (it converts and caches ``<ckpt>.npz``), the
    ``.npz`` write alone and the second ``load_pretrained`` (the cache),
    timed, each result bit for bit ``init_params(0)``; then the transfer CLI
    at stack 0 from ``--ckpt_path <prefix>`` (the cache removed, so its first
    run converts) in bf16 and f32: the launches of the ``--random_init`` run
    (``ref``), and in f32 its losses exactly. Returns the two CLI runs."""
    import torch

    from audio_style_transfer_tpu_torch.ckpt import bundle_reader, convert
    from audio_style_transfer_tpu_torch.models.wavenet_ae import WaveNetAEConfig, init_params
    from audio_style_transfer_tpu_torch.tools.tf1_bundle import nsynth_variables, write_bundle

    label = "tf1 checkpoint"
    want = init_params(0, WaveNetAEConfig())
    variables = nsynth_variables(want)
    rng = np.random.RandomState(0)
    variables["global_step"] = np.array(200000, np.int64)
    for name in TF1_SLOT_LAYERS:
        shape = variables[f"{name}/W"].shape
        for slot in ("Adam", "ExponentialMovingAverage"):
            variables[f"{name}/W/{slot}"] = rng.standard_normal(shape).astype(np.float32)
    n_bytes = sum(v.nbytes for v in variables.values())

    def check_bits(what: str, got: dict) -> None:
        if got.keys() != want.keys():
            raise AssertionError(f"[{label}] {what}: layers {sorted(set(got) ^ set(want))} "
                                 "differ from init_params(0)'s")
        for name, entry in want.items():
            for k, v in entry.items():
                g = got[name][k]
                if g.device != dev or g.dtype != torch.float32 or not torch.equal(g.cpu(), v):
                    raise AssertionError(f"[{label}] {what}: {name}/{k} is not init_params(0)'s "
                                         f"bits on {dev} ({g.dtype}, {g.device})")

    def timed(fn, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    runs, times = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "model.ckpt-200000")
        npz = prefix + ".npz"
        _, times["bundle write (crc off)"] = timed(write_bundle, prefix, variables, crc=False)

        def read_all():
            reader = bundle_reader.BundleReader(prefix)
            return {k: reader.get_tensor(k) for k in reader.get_variable_to_shape_map()}

        read, times["bundle read"] = timed(read_all)
        if read.keys() != variables.keys() or any(
                read[k].dtype != v.dtype or read[k].tobytes() != v.tobytes()
                for k, v in variables.items()):
            raise AssertionError(f"[{label}] the bundle read back differs from what was written")
        got, times["convert_tf1_checkpoint"] = timed(convert.convert_tf1_checkpoint, prefix,
                                                     device=dev)
        check_bits("convert_tf1_checkpoint", got)
        if os.path.exists(npz):
            raise AssertionError(f"[{label}] convert_tf1_checkpoint wrote {npz}")
        got, times["load_pretrained, converting"] = timed(convert.load_pretrained, prefix,
                                                          device=dev)
        check_bits("first load_pretrained", got)
        if not os.path.exists(npz):
            raise AssertionError(f"[{label}] the first load_pretrained cached no {npz}")
        _, times[".npz write alone"] = timed(convert.save_params, os.path.join(tmp, "w.npz"),
                                             got)
        converter = convert.convert_tf1_checkpoint

        def refuse(*args, **kwargs):
            raise AssertionError(f"[{label}] the second load_pretrained converted again")

        convert.convert_tf1_checkpoint = refuse
        try:
            got, times["load_pretrained, .npz"] = timed(convert.load_pretrained, prefix,
                                                        device=dev)
        finally:
            convert.convert_tf1_checkpoint = converter
        check_bits("second load_pretrained", got)
        del got, read
        print(f"[{label}] {len(want)} layers and {len(variables) - 2 * len(want)} other "
              f"variables, {n_bytes / 1e6:.1f} MB; "
              + ", ".join(f"{k} {v:.3f} s" for k, v in times.items())
              + f"; every result init_params(0)'s bits on {dev} ok ({smi})")

        os.remove(npz)  # the CLI's first run converts on first use
        loader = convert.load_pretrained
        load_s = []

        def timed_load(*args, **kwargs):
            out, seconds = timed(loader, *args, **kwargs)
            load_s.append(seconds)
            return out

        for precision, suffix in (("bfloat16", ""), ("float32", ", float32")):
            run_label = f"{label}, cli stack 0{suffix}"
            convert.load_pretrained = timed_load
            try:
                runs[run_label] = cli_phase(dev, run_label, ["--stack", "0"],
                                            {"K1", "K2", "K5", "K6"}, precision=precision,
                                            weights=("--ckpt_path", prefix))
            finally:
                convert.load_pretrained = loader
            if not os.path.exists(npz):
                raise AssertionError(f"[{label}] the CLI from --ckpt_path cached no {npz}")
            launches, evals, wall, _, losses = runs[run_label]
            r_launches, r_evals, r_wall, _, r_losses = ref[f"cli stack 0{suffix}"]
            if launches["K2"] != LAYERS * evals or launches["K1"] % LAYERS \
                    or launches["K1"] < LAYERS * evals:
                raise AssertionError(f"[{run_label}] launches {launches} for {evals} evals: "
                                     f"want K2 {LAYERS} and K1 at least {LAYERS} an evaluation")
            same = losses == r_losses and launches == r_launches
            print(f"[{run_label}] weights loaded in {load_s[-1]:.3f} s "
                  f"({'converting the bundle' if precision == 'bfloat16' else 'the .npz cache'}) "
                  f"of a {wall:.2f} s CLI wall ({100 * load_s[-1] / wall:.1f}%); the "
                  f"--random_init run: {r_evals} evals in {r_wall:.2f} s, losses {r_losses}; "
                  f"the same losses and launches: {same} ({smi})")
            if precision == "float32" and not same:
                raise AssertionError(f"[{run_label}] losses {losses} and launches {launches} "
                                     f"differ from the --random_init run's {r_losses} and "
                                     f"{r_launches} on the same weights")
    return runs


def exact_first_eval(engine, t_total: int, window: int, t_valid: int) -> tuple:
    """The exact long-form value-and-gradient function of ``engine`` with
    its inputs at the optimizer's start: the first t_valid samples of the
    15 s content clip, zero-padded to t_total and scanned in
    ``window``-sample windows (one window when window == t_total), with the
    content target made in that geometry, as transfer_exact makes it.
    Returns (vg, params, x at 1e-6, phi_c, phi_s)."""
    import torch

    from audio_style_transfer_tpu_torch.parallel import halo
    from audio_style_transfer_tpu_torch.signal.mu_law import mu_law_numpy

    content = synth_audio(EXACT_SAMPLES / 16000, kind="content")[:t_valid]
    xq = engine._tensor(mu_law_numpy(np.pad(content, (0, t_total - t_valid))[None]))
    phi_s = engine._tensor(engine.get_style_phi(synth_audio(3.0, kind="style")))
    geometry = (engine.cfg, engine.loss_spec, t_total, window, t_valid)
    with torch.no_grad():
        phi_c, _ = halo.make_scan_exact_embeds_fn(*geometry)(engine.params, xq)
    x = torch.full((1, t_total), 1e-6, device=xq.device)
    return (halo.make_scan_exact_value_and_grad_fn(*geometry), engine.params, x,
            phi_c.to(torch.float32), phi_s)


# Tolerances of one exact evaluation against another that runs other kernels
# or sums in another order (exact_flavours_phase's docstring): (loss rtol,
# gradient max|d| over its largest entry).
EXACT_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-3, 2e-2)}


def exact_flavours_phase(params, dev, dtype_name: str) -> None:
    """The exact long-form loss and its waveform gradient at the 1e-6 start
    (the optimizer's first evaluation) on the 15 s clip, full width, stack 0,
    gamma 1e-3: one unmasked window against the scan over halo-extended
    windows with the pad masked. Both flavours run the same kernels row for
    row on the valid rows; what differs is the order of the gram's and the
    content term's float32 sums across windows (about 1e-6), and in bfloat16
    a tap cotangent that lands on the other side of a rounding boundary
    (2^-8 of it). Hence EXACT_TOL: loss rtol 1e-4 / 1e-3 and gradient max|d|
    within 1e-4 / 2e-2 of its largest entry (float32 / bfloat16)."""
    import torch

    from audio_style_transfer_tpu_torch.transfer.engine import StyleTransfer, TransferSpec

    engine = StyleTransfer(TransferSpec(stack=0, gamma=1e-3, compute_dtype=dtype_name,
                                        fused_encoder=True, write_artifacts=False,
                                        device=str(dev)), params)
    t_valid = (EXACT_SAMPLES // 4096) * 4096
    t_total = -(-t_valid // SCAN_WINDOW) * SCAN_WINDOW
    vg, p, x, phi_c, phi_s = exact_first_eval(engine, t_valid, t_valid, t_valid)
    f1, g1 = vg(p, x, phi_c, phi_s)
    vg, p, x, phi_c, phi_s = exact_first_eval(engine, t_total, SCAN_WINDOW, t_valid)
    f2, g2 = vg(p, x, phi_c, phi_s)
    torch.cuda.synchronize()
    loss_tol, grad_tol = EXACT_TOL[dtype_name]
    print(f"[exact flavours {dtype_name}] first evaluation on {t_valid} samples: one window "
          f"{float(f1):.6f}, scan of {t_total // SCAN_WINDOW} windows {float(f2):.6f}")
    check("loss, scan against one window", f2, f1, loss_tol)
    check("waveform gradient, scan against one window", g2[:, :t_valid], g1, grad_tol)
    if bool(g2[:, t_valid:].any()):
        raise AssertionError("exact scan: the pad tail's gradient is not zero")


@contextlib.contextmanager
def lbfgs_clock():
    """While open, ``lbfgs_minimize`` is timed (the device drained either
    side) and its seconds summed into the yielded one-element list."""
    import torch

    from audio_style_transfer_tpu_torch.transfer import lbfgs

    seconds, original = [0.0], lbfgs.lbfgs_minimize

    def timed_minimize(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = original(*args, **kwargs)
        torch.cuda.synchronize()
        seconds[0] += time.perf_counter() - t0
        return out

    lbfgs.lbfgs_minimize = timed_minimize
    try:
        yield seconds
    finally:
        lbfgs.lbfgs_minimize = original


def exact_phase(dev, label: str, scan_window):
    """The exact long-form CLI (bf16, stack 0, gamma 1e-3, 2 epochs) on the
    15 s clip, as one window or as a scan; returns (launches, evals, wall
    seconds, final loss)."""
    import torch

    from audio_style_transfer_tpu_torch.cli.transfer import main
    from audio_style_transfer_tpu_torch.ops import _build
    from audio_style_transfer_tpu_torch.transfer import longform

    scan = scan_window is not None
    quantum = 512 if scan else 4096
    t_valid = (EXACT_SAMPLES // quantum) * quantum
    t_total = -(-t_valid // scan_window) * scan_window if scan else t_valid
    n_win = t_total // scan_window if scan else 1
    captured, original = {}, longform.transfer_exact

    def keep_result(*args, **kwargs):
        captured["res"] = original(*args, **kwargs)
        return captured["res"]

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
        longform.transfer_exact = keep_result
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf), lbfgs_clock() as in_lbfgs:
                audio = main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(_build.LAUNCHES)
            peak = torch.cuda.max_memory_allocated()
        finally:
            longform.transfer_exact = original
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
    want = {k: 0 for k in KERNELS}
    want.update(K1=LAYERS * (passes * n_win * evals + 7 + n_win), K2=LAYERS * n_win * evals,
                K5=passes * n_win * evals + 7 + n_win, K6=n_win * evals)
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


def per_layer_window_phase(params, dev):
    """The per-layer flavour's exact scan (bf16, stack 0) in
    PER_LAYER_SCAN-sample windows, whose edge windows run the windowed K7f /
    K7b: its first evaluation's loss and gradient against the chained
    flavour's (EXACT_TOL), then one epoch of L-BFGS through transfer_exact;
    returns (launches, evals, wall seconds) of that epoch."""
    import torch

    from audio_style_transfer_tpu_torch.ops import _build
    from audio_style_transfer_tpu_torch.transfer import longform
    from audio_style_transfer_tpu_torch.transfer.engine import StyleTransfer, TransferSpec

    label = "per-layer exact scan"
    spec = TransferSpec(stack=0, batch_size=T, epochs=1, maxiter=PER_LAYER_MAXITER,
                        compute_dtype="bfloat16", fused_encoder=True, chain_encoder=False,
                        write_artifacts=False, device=str(dev))
    engine = StyleTransfer(spec, params)
    _, _, edges, t_valid, t_total = scan_cases(PER_LAYER_SAMPLES, PER_LAYER_SCAN)
    chained = StyleTransfer(dataclasses.replace(spec, chain_encoder=True), params)
    out = {}
    for flavour, eng in (("per-layer", engine), ("chained", chained)):
        vg, p, x, phi_c, phi_s = exact_first_eval(eng, t_total, PER_LAYER_SCAN, t_valid)
        _build.reset_launches()
        f, g = vg(p, x, phi_c, phi_s)
        torch.cuda.synchronize()
        out[flavour] = (f, g, {k: v for k, v in _build.LAUNCHES.items() if v})
    (f0, g0, launches0), (f1, g1, launches1) = out["chained"], out["per-layer"]
    print(f"[{label}] first evaluation over {t_total // PER_LAYER_SCAN} windows (edge windows "
          f"{edges}): loss {float(f1):.6f} per-layer, {float(f0):.6f} chained; launches "
          f"{launches1} per-layer, {launches0} chained")
    if set(launches1) != {"K7f", "K7b", "K5", "K6"} or "K7b" in launches0:
        raise AssertionError(f"{label}: the flavours' first evaluations ran {launches1} and "
                             f"{launches0}")
    loss_tol, grad_tol = EXACT_TOL["bfloat16"]
    check("loss, per-layer against chained", f1, f0, loss_tol)
    check("waveform gradient, per-layer against chained", g1, g0, grad_tol)
    del chained, out
    content = synth_audio(PER_LAYER_SAMPLES / 16000, kind="content")
    print(f"[{label}] {PER_LAYER_SAMPLES} samples, --scan_window {PER_LAYER_SCAN}, stack 0, bf16, "
          f"fused_encoder=True, chain_encoder=False, 1 epoch, maxiter {spec.maxiter}")
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    res = longform.transfer_exact(engine, content, synth_audio(2.0, kind="style"),
                                  scan_window=PER_LAYER_SCAN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    per = res.per_window
    losses = [float(v) for v in per["metrics"]]
    evals = int(np.sum(per["evals"]))
    check_losses(label, losses, res.audio, samples=t_valid)
    # Every window's forward runs again in the scan's second pass: K5 twice
    # per window and evaluation, K6 once.
    check_launches(label, launches, {"K7f", "K7b", "K5", "K6"},
                   evals * (per["t_optimized"] // PER_LAYER_SCAN))
    print(f"[{label}] losses {losses}, {evals} L-BFGS evals over "
          f"{per['t_optimized'] // PER_LAYER_SCAN} windows in {wall:.2f} s wall "
          f"({evals / wall:.2f} evals/s, setup included)")
    return launches, evals, wall


def exact_wavefront_phase(params, dev) -> tuple:
    """The exact scan on the 15 s clip (bf16, stack 0, gamma 1e-3) with the
    wavefront backward on: its edge windows run K2-wf with a valid window.
    The first evaluation's loss and gradient against the same evaluation
    with it off: bit for bit (K2-wf equals the K2 launches it replaces, the
    rest of the evaluation is the same code); its ms per evaluation with the
    wavefront off, on, on, off; then EXACT_WF_MAXITER evaluations of L-BFGS
    through transfer_exact with it on. Returns (launches, evals, wall
    seconds) of that run."""
    import torch

    from audio_style_transfer_tpu_torch.ops import _build, chain
    from audio_style_transfer_tpu_torch.transfer import longform
    from audio_style_transfer_tpu_torch.transfer.engine import StyleTransfer, TransferSpec

    label = "exact scan, wavefront on"
    spec = TransferSpec(stack=0, gamma=1e-3, batch_size=T, compute_dtype="bfloat16",
                        fused_encoder=True, epochs=1, maxiter=EXACT_WF_MAXITER,
                        write_artifacts=False, device=str(dev))
    engine = StyleTransfer(spec, params)
    w_ext, _, edges, t_valid, t_total = scan_cases(EXACT_SAMPLES, SCAN_WINDOW)
    n_win = t_total // SCAN_WINDOW
    n_wf, n_k2 = wavefront_launches(w_ext)
    content = synth_audio(EXACT_SAMPLES / 16000, kind="content")
    vg, p, x, phi_c, phi_s = exact_first_eval(engine, t_total, SCAN_WINDOW, t_valid)
    was = chain._BWD_WAVEFRONT
    out = {}
    try:
        for on in (False, True):
            chain._BWD_WAVEFRONT = on
            _build.reset_launches()
            f, g = vg(p, x, phi_c, phi_s)
            out[on] = (f, g, dict(_build.LAUNCHES))
        torch.cuda.synchronize()
        (f0, g0, _), (f1, g1, launches) = out[False], out[True]
        want = {"K2wf": n_wf * n_win, "K2": n_k2 * n_win}
        if {k: launches[k] for k in want} != want:
            raise AssertionError(f"{label}: one evaluation launched {launches}, expected {want}")
        print(f"[{label}] first evaluation over {n_win} windows (edge windows {edges}): "
              f"loss {float(f1):.6f} against {float(f0):.6f} with the wavefront off; launches "
              f"{launches}")
        loss_tol, grad_tol = EXACT_TOL["bfloat16"]
        check("loss, wavefront on against off", f1, f0, loss_tol)
        check("waveform gradient, wavefront on against off", g1, g0, grad_tol)
        if not (torch.equal(f1, f0) and torch.equal(g1, g0)):
            raise AssertionError(f"{label}: the first evaluation differs from the wavefront off")
        print(f"[{label}] first evaluation equal to the wavefront off bit for bit ok")
        ms = {}
        for on in (False, True, True, False):
            chain._BWD_WAVEFRONT = on
            ms.setdefault(on, []).append(
                cuda_ms(lambda: vg(p, x, phi_c, phi_s), reps=3, warmup=1))
        print(f"[{label}] ms per evaluation over {n_win} windows (CUDA events around one "
              f"evaluation, median of 3): wavefront off {ms[False][0]:.3f}, on {ms[True][0]:.3f}, "
              f"on {ms[True][1]:.3f}, off {ms[False][1]:.3f}")
        chain._BWD_WAVEFRONT = True
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        res = longform.transfer_exact(engine, content, synth_audio(3.0, kind="style"),
                                      scan_window=SCAN_WINDOW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
    finally:
        chain._BWD_WAVEFRONT = was
    per = res.per_window
    losses = [float(v) for v in per["metrics"]]
    evals = int(np.sum(per["evals"]))
    check_losses(label, losses, res.audio, samples=t_valid)
    if launches["K2wf"] != n_wf * n_win * evals or launches["K2"] != n_k2 * n_win * evals:
        raise AssertionError(f"{label}: launches {launches} for {evals} evals over {n_win} "
                             f"windows, expected K2wf {n_wf * n_win} and K2 {n_k2 * n_win} per "
                             f"eval (the plan at {w_ext} rows)")
    check_launches(label, launches, {"K1", "K2", "K2wf", "K5", "K6"}, n_win * evals)
    print(f"[{label}] losses {losses}, {evals} L-BFGS evals in {wall:.2f} s wall, K2wf "
          f"{launches['K2wf']} = {n_wf} x {n_win} windows x {evals} evals ok")
    return launches, evals, wall


# Generation: save_embeddings' default batch (16 clips of 64 000 samples) for
# the encoder; the decoder at full width (30 layers of 512, skip 256).
GEN_CLIPS, GEN_SAMPLES = 16, 64000
GEN_FRAMES = 8  # frames of each timed synthesis (4096 samples)
GEN_CHECK_FRAMES = 4  # frames of the graphed decoder against decode_logits
GEN_CLI_SAMPLES = 8192  # samples of each wav of the CLI runs
GEN_BATCHES = (1, 8, 32)
GEN_FORMATS = ("float32", "bfloat16", "int8")
GEN_STEPS = 64  # steps of the graphed-against-eager and card-against-CPU checks
GEN_EAGER_STEPS = 32  # steps of the eager loop's timing
# Logits, max|d| <= rel * max|ref| + abs: f32 sums of 30 residual layers in
# another order (the same bound for bf16 weights: f32 products of
# bf16-rounded weights); int8 rounds x to bf16 before each product.
GEN_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (1e-4, 1e-5), "int8": (1e-3, 1e-4)}
# The encodings of the f32 encoder on the card against the plain K1 path on
# the CPU: 30 layers of f32 sums in another order.
ENCODE_TOL = 1e-4


def on_device(params, dev) -> dict:
    return {k: {n: v.to(dev) for n, v in e.items()} for k, e in params.items()}


def gen_clips(n: int, samples: int) -> np.ndarray:
    """n distinct clips: the two synthetic kinds, each rolled its own way."""
    return np.stack([np.roll(synth_audio(samples / 16000, kind=("content", "style")[i % 2]),
                             997 * i)[:samples] for i in range(n)])


def check_logits(name: str, got, ref, fmt: str) -> float:
    rel, abs_ = GEN_TOL[fmt]
    err = float((got.float().cpu() - ref.float().cpu()).abs().max())
    limit = rel * float(ref.abs().max()) + abs_
    ok = err <= limit
    print(f"  {name}: max|d| {err:.3e} (limit {limit:.3e} = {rel:.0e} * max|ref| + {abs_:.0e}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: logits disagree")
    return err


def generate_encode_phase(params, dev) -> tuple[dict, np.ndarray]:
    """``encode`` on 16 clips of 64 000 samples, f32: K1 30 times and nothing
    else, its peak memory beside what keeping every layer's output and mask
    bytes would hold, and the first two clips against the plain K1 path on
    the CPU. Returns (launches, encodings)."""
    import torch

    from audio_style_transfer_tpu_torch.generate import fastgen
    from audio_style_transfer_tpu_torch.ops import _build

    label = "generate encode"
    wav = gen_clips(GEN_CLIPS, GEN_SAMPLES)
    p_dev = on_device(params, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    enc = fastgen.encode(wav, p_dev, sample_length=GEN_SAMPLES)
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    rows = GEN_CLIPS * GEN_SAMPLES
    held = LAYERS * rows * C * 4 + LAYERS * rows * C  # f32 outputs + mask bytes
    print(f"[{label}] {GEN_CLIPS} clips x {GEN_SAMPLES} samples, f32: {enc.shape} in "
          f"{wall:.3f} s; peak device memory {peak / 1e9:.3f} GB ({(peak - base) / 1e9:.3f} GB "
          f"above the {base / 1e9:.3f} GB held before the call); keeping every layer's output "
          f"and mask bytes would hold {held / 1e9:.3f} GB more")
    want = {k: LAYERS if k == "K1" else 0 for k in KERNELS}
    if launches != want:
        raise AssertionError(f"[{label}] launches {launches}, expected {want}")
    print(f"[{label}] launches {launches}: K1 {LAYERS}, the rest 0 ok")
    if peak - base >= held:
        raise AssertionError(f"[{label}] the gradient-free pass held {peak - base} bytes")
    if not np.all(np.isfinite(enc)) or enc.shape != (GEN_CLIPS, GEN_SAMPLES // 512, 16):
        raise AssertionError(f"[{label}] encodings not finite or of shape {enc.shape}")
    enc_cpu = fastgen.encode(wav[:2], params, sample_length=GEN_SAMPLES)
    check("encodings of clips 0-1, card (K1) vs CPU (plain)", torch.tensor(enc[:2]),
          torch.tensor(enc_cpu), ENCODE_TOL)
    return launches, enc


def generate_decoder_phase(params, dev, enc16: np.ndarray) -> None:
    """The graphed step against its references, f32, B=2: the graphed
    ``incremental_logits`` against ``decode_logits`` on the card over 4
    frames; the first steps graphed against eager on the card bit for bit,
    and against the CPU's plain loop; the sampler graphed against eager bit
    for bit on one frame."""
    import torch

    from audio_style_transfer_tpu_torch.generate import fastgen
    from audio_style_transfer_tpu_torch.models.wavenet_ae import decode_logits
    from audio_style_transfer_tpu_torch.signal.mu_law import mu_law_numpy

    label = "generate decoder"
    p_dev = on_device(params, dev)
    frames = GEN_CHECK_FRAMES
    xq = mu_law_numpy(gen_clips(2, frames * 512)).astype(np.float32)
    enc = enc16[:2, :frames]
    t0 = time.perf_counter()
    got = fastgen.incremental_logits(p_dev, xq, enc)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ref = decode_logits(p_dev, torch.tensor(xq, device=dev), torch.tensor(enc, device=dev))
    print(f"[{label}] f32, B=2, {frames} frames ({frames * 512} steps, graphed, {wall:.3f} s "
          f"with set-up): incremental_logits against decode_logits on the card")
    check_logits("graphed incremental vs teacher-forced", got, ref, "float32")
    n = GEN_STEPS
    graphed = fastgen.incremental_logits(p_dev, xq[:, :n], enc[:, :1])
    eager = fastgen.incremental_logits(p_dev, xq[:, :n], enc[:, :1], eager=True)
    torch.cuda.synchronize()
    if not torch.equal(graphed, eager):
        raise AssertionError(f"[{label}] graphed step differs from the eager step")
    print(f"  first {n} steps, graphed vs eager on the card: equal bit for bit ok "
          f"(and the {frames}-frame run's first {n}: "
          f"{'equal' if torch.equal(got[:, :n], graphed) else 'differ'})")
    cpu = fastgen.incremental_logits(params, xq[:, :n], enc[:, :1])
    check_logits(f"first {n} steps, card vs CPU", graphed, cpu, "float32")
    audio = [fastgen.sample_loop(p_dev, enc[:, :1], torch.Generator(device=dev).manual_seed(0),
                                 eager=e) for e in (False, True)]
    if not torch.equal(audio[0], audio[1]):
        raise AssertionError(f"[{label}] graphed sampler differs from the eager one")
    print(f"  sampler, one frame ({512} steps), graphed vs eager: equal bit for bit ok")


def generate_synth_phase(params, dev, enc16: np.ndarray, smi: str) -> list:
    """``synthesize`` over 8 frames at B in {1, 8, 32} x {f32, bf16, int8}:
    us per sample per stream (the set-up included, and steady: the 8-frame
    run less a 1-frame run), aggregate samples/s, the weight-streaming floor
    of a step, the ratio to it, peak memory and the cond bytes; then the
    eager loop's us per step at B=1 f32. Returns the rows."""
    import torch

    from audio_style_transfer_tpu_torch.generate import fastgen
    from audio_style_transfer_tpu_torch.models.wavenet_ae import WaveNetAEConfig
    from portbench import counts

    label = "generate synth"
    cfg = WaveNetAEConfig()
    p_dev = on_device(params, dev)
    steps = GEN_FRAMES * 512
    kwargs = {"float32": {}, "bfloat16": {"dtype": torch.bfloat16}, "int8": {"quantize": "int8"}}
    stored = {"float32": p_dev, "bfloat16": {k: {n: v.to(torch.bfloat16) for n, v in e.items()}
                                             for k, e in p_dev.items()},
              "int8": fastgen.quantize_params_int8(p_dev)}
    rows = []
    for fmt in GEN_FORMATS:
        floor_us = fastgen.decoder_weight_bytes(stored[fmt], cfg) / counts.PEAK_BYTES_S * 1e6
        for b in GEN_BATCHES:
            enc = np.stack([enc16[i % GEN_CLIPS, GEN_FRAMES * (i // GEN_CLIPS):][:GEN_FRAMES]
                            for i in range(b)])
            walls = {}
            for frames in (1, GEN_FRAMES):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                t0 = time.perf_counter()
                audio = fastgen.synthesize(enc[:, :frames], params=p_dev, seed=0, **kwargs[fmt])
                walls[frames] = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated(dev)
            us = walls[GEN_FRAMES] / steps * 1e6
            steady = (walls[GEN_FRAMES] - walls[1]) / (steps - 512) * 1e6
            row = {"format": fmt, "batch": b, "us_per_sample": us, "steady_us": steady,
                   "samples_per_s": b * steps / walls[GEN_FRAMES], "floor_us": floor_us,
                   "ratio": steady / floor_us, "peak_gb": peak / 1e9,
                   "cond_bytes": fastgen.cond_bytes(cfg, b, GEN_FRAMES)}
            rows.append(row)
            print(f"[{label}] {fmt} B={b}: {us:.1f} us per sample per stream with set-up, "
                  f"{steady:.1f} steady; {row['samples_per_s']:.0f} samples/s; floor "
                  f"{floor_us:.1f} us per step (weights over "
                  f"{counts.PEAK_BYTES_S / 1e12:.2f} TB/s, shared by the batch), steady / floor "
                  f"{row['ratio']:.1f}; peak {row['peak_gb']:.3f} GB; cond {row['cond_bytes']} B "
                  f"({smi})")
            ok = (audio.shape == (b, steps) and np.all(np.isfinite(audio))
                  and np.abs(audio).max() <= 1.0 and np.abs(audio).max() > 0)
            if not ok:
                raise AssertionError(f"[{label}] {fmt} B={b}: audio of shape {audio.shape}, "
                                     f"max |x| {np.abs(audio).max()}")
    xq = np.zeros((1, GEN_EAGER_STEPS), np.float32)
    for eager in (True, False):
        fastgen.incremental_logits(p_dev, xq, enc16[:1, :1], eager=eager)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fastgen.incremental_logits(p_dev, xq, enc16[:1, :1], eager=eager)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / GEN_EAGER_STEPS * 1e3
        print(f"[{label}] {'eager' if eager else 'graphed'} loop, f32 B=1: {ms:.3f} ms per step "
              f"over {GEN_EAGER_STEPS} steps (set-up included)")
    return rows


def generate_device_ops(params, dev, step_us: float) -> None:
    """What the graphed step's device time goes to, f32, B=1: torch.profiler
    over a graphed teacher-forced run of 32 and one of 96 steps; the
    difference, per step and by kernel, is the replays' alone (the warm-up
    step, the capture and the set-up cancel). ``step_us`` is the step's wall
    time from the synth phase, for the busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from audio_style_transfer_tpu_torch.generate import fastgen

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    p_dev = on_device(params, dev)
    enc = np.zeros((1, 1, 16), np.float32)
    per = {}
    for steps in (32, 96):
        xq = np.zeros((1, steps), np.float32)
        fastgen.incremental_logits(p_dev, xq, enc)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fastgen.incremental_logits(p_dev, xq, enc)
            torch.cuda.synchronize()
        per[steps] = {e.key: (e.count, device_us(e)) for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA}
    keys = set(per[32]) | set(per[96])
    diff = {k: tuple((per[96].get(k, (0, 0.0))[i] - per[32].get(k, (0, 0.0))[i]) / 64
                     for i in (0, 1)) for k in keys}
    count = sum(c for c, _ in diff.values())
    us = sum(t for _, t in diff.values())
    if count <= 0:
        print("[generate step] device operations per step: not measured (the profiler saw none)")
        return
    top = sorted(diff.items(), key=lambda kv: -kv[1][1])[:6]
    print(f"[generate step] graphed, f32 B=1 (96-step run less 32-step run, per step): "
          f"{count:.1f} device operations, {us:.1f} us of device time, busy share "
          f"{us / step_us:.3f} of the {step_us:.1f} us step; largest: "
          + "; ".join(f"{k[:48]} x{c:.1f} {t:.1f} us" for k, (c, t) in top))


def generate_cli_phase(params, dev) -> None:
    """Both CLIs as subprocesses on the card: ``init_params(0)`` as the .npz
    checkpoint, two synthetic 8192-sample wavs; save_embeddings, then
    generate from the .npy files, and beside them generate from the wav
    directory with --int8."""
    from audio_style_transfer_tpu_torch.utils.audio_io import read_wav

    label = "generate cli"
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "w.npz")
        np.savez(ckpt, **{f"{k}/{n}": v.cpu().numpy() for k, e in params.items()
                          for n, v in e.items()})
        wavs = os.path.join(tmp, "wavs")
        os.makedirs(wavs)
        for name, kind in (("a", "content"), ("b", "style")):
            write_wav(os.path.join(wavs, f"{name}.wav"),
                      synth_audio(GEN_CLI_SAMPLES / 16000, kind=kind))
        def argv(cli, args):
            return [sys.executable, "-m", f"audio_style_transfer_tpu_torch.cli.{cli}", *args,
                    "--checkpoint_path", ckpt, "--device", str(dev)]

        def report(cli, args, rc, out, err, t0):
            shown = " ".join(os.path.relpath(a, tmp) if a.startswith(tmp) else a for a in args)
            print(f"[{label}] {cli} {shown}: rc {rc} in {time.perf_counter() - t0:.1f} s")
            if rc != 0:
                raise AssertionError(f"[{label}] {cli} failed:\n{out}\n{err[-3000:]}")

        # generate from the wavs needs nothing of the other two: it runs beside them.
        side_args = ["--source_path", wavs, "--save_path", os.path.join(tmp, "gen_wav"),
                     "--batch_size", "2", "--int8"]
        t_side = time.perf_counter()
        side = subprocess.Popen(argv("generate", side_args), cwd=here, env=env, text=True,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        try:
            for cli, args in (
                ("save_embeddings", ["--source_path", wavs, "--save_path",
                                     os.path.join(tmp, "emb")]),
                ("generate", ["--source_path", os.path.join(tmp, "emb"), "--save_path",
                              os.path.join(tmp, "gen_npy"), "--batch_size", "2"]),
            ):
                t0 = time.perf_counter()
                r = subprocess.run(argv(cli, args), cwd=here, env=env, capture_output=True,
                                   text=True, timeout=600)
                report(cli, args, r.returncode, r.stdout, r.stderr, t0)
            out, err = side.communicate(timeout=600)
            report("generate", side_args, side.returncode, out, err, t_side)
        finally:
            if side.poll() is None:
                side.kill()
                side.communicate()
        for name in ("a", "b"):
            enc = np.load(os.path.join(tmp, "emb", f"{name}_embeddings.npy"))
            if enc.shape != (GEN_CLI_SAMPLES // 512, 16) or not np.all(np.isfinite(enc)):
                raise AssertionError(f"[{label}] embedding {name}: {enc.shape}")
            for out in (f"gen_npy/gen_{name}_embeddings.wav", f"gen_wav/gen_{name}.wav"):
                audio, sr = read_wav(os.path.join(tmp, out))
                if audio.shape != (1, GEN_CLI_SAMPLES) or not np.all(np.isfinite(audio)) \
                        or sr != 16000:
                    raise AssertionError(f"[{label}] {out}: {audio.shape} at {sr}")
        print(f"[{label}] embeddings [{GEN_CLI_SAMPLES // 512}, 16] and {GEN_CLI_SAMPLES}-sample "
              "wavs from both generate runs exist and are finite ok")


# ---------------------------------------------------------------------- #
# Training (M7): train/trainer.py at full width.
# ---------------------------------------------------------------------- #

TRAIN_PARITY_SHAPE = (2, 2048)  # card against CPU: a length the CPU steps in seconds
TRAIN_SHAPE = (32, 6144)  # TrainConfig()'s defaults: the reference step
TRAIN_STEPS = 10  # steps on one batch; all but the first (warm-up) timed
TRAIN_FIT = dict(total_batch_size=8, sample_length=6144, steps_per_call=4)
TRAIN_FIT_STEPS = 6  # one full group of 4, then a partial group of 2
TRAIN_FIT_EXAMPLES = 16  # 64000-sample examples in the synthetic TFRecord
TRAIN_CLI_ITERS = 3
TRAIN_CLI_BATCH = 8  # x 6144 samples, the CLI's default length
# f32 card against CPU after one step (TF32 off): the loss rel 1e-5; each
# gradient rel L2 5e-3 (PRs 1-3 saw a waveform-gradient rel L2 of 1.1e-3
# from relu gates near zero flipping); Adam's first step moves a weight by
# lr * g / (|g| + eps), about lr whatever |g|, so the updated weights may
# differ (by up to 2 lr) only where a gradient near zero differs in sign or
# size: more than 1e-6 on at most 1e-3 of them.
TRAIN_LOSS_TOL = 1e-5
TRAIN_GRAD_TOL = 5e-3
TRAIN_FLIP_SHARE = 1e-3
TRUNK_REPS = 3  # timed forward + backward passes of each trunk path


def train_batch(shape, seed: int) -> np.ndarray:
    """Audio-like batch in (-1, 1): each row a few tones at random pitches
    with noise (no sample at +1.0: its label 256 makes the loss NaN, as in
    the reference)."""
    rng = np.random.RandomState(seed)
    b, t = shape
    time_s = np.arange(t) / 16000.0
    rows = []
    for _ in range(b):
        f = 110.0 * 2 ** rng.uniform(0, 4, 3)
        x = sum(rng.uniform(0.1, 0.3) * np.sin(2 * np.pi * fk * time_s + rng.uniform(0, 6))
                for fk in f)
        rows.append(x + 0.02 * rng.randn(t))
    return np.clip(np.stack(rows), -0.99, 0.99).astype(np.float32)


def _train_leaves(tree):
    return [tree[layer][k] for layer in sorted(tree) for k in sorted(tree[layer])]


def train_parity_phase(dev) -> None:
    """(a) One f32 step at full width on 2 x 2048 samples, card against CPU
    from the same weights and batch: the loss, every gradient, the updated
    weights."""
    import torch

    from audio_style_transfer_tpu_torch.train import TrainConfig, Trainer, learning_rate

    label = "train parity"
    b, t = TRAIN_PARITY_SHAPE
    wav = train_batch(TRAIN_PARITY_SHAPE, 1)
    cfg = TrainConfig(total_batch_size=b, sample_length=t, save_every_steps=0)
    out = {}
    for where in ("cpu", str(dev)):
        tr = Trainer(cfg, device=where)
        st = tr.init_state()
        before = [p.detach().cpu().clone() for p in _train_leaves(st["params"])]
        t0 = time.perf_counter()
        st, loss = tr.step(st, wav)
        loss = float(loss)
        wall = time.perf_counter() - t0
        grads = [p.grad.detach().cpu() for p in _train_leaves(st["params"])]
        after = [p.detach().cpu() for p in _train_leaves(st["params"])]
        out[where] = (loss, grads, after, before, wall)
    (lc, gc, pc, p0, wc), (lg, gg, pg, _, wg) = out["cpu"], out[str(dev)]
    print(f"[{label}] f32, full width, {b} x {t} samples, one step: loss card {lg:.8f} "
          f"cpu {lc:.8f}; step {wg:.2f} s on the card (first, with set-up), {wc:.2f} s on "
          "the CPU")
    rel = abs(lg - lc) / abs(lc)
    if not rel <= TRAIN_LOSS_TOL:
        raise AssertionError(f"[{label}] loss rel {rel:.3e} > {TRAIN_LOSS_TOL:.0e}")
    worst = max((float((a - c).norm() / c.norm().clamp_min(1e-30)), i)
                for i, (a, c) in enumerate(zip(gg, gc)) if float(c.norm()) > 0)
    zero = [i for i, c in enumerate(gc) if float(c.norm()) == 0]
    if not all(float(gg[i].abs().max()) == 0 for i in zero):
        raise AssertionError(f"[{label}] gradients zero on the CPU but not on the card")
    if not worst[0] <= TRAIN_GRAD_TOL:
        raise AssertionError(f"[{label}] gradient {worst[1]} rel L2 {worst[0]:.3e}")
    max_d = max(float((a - c).abs().max()) for a, c in zip(pg, pc))
    moved = sum(int(((a - c).abs() > 1e-6).sum()) for a, c in zip(pg, pc))
    total = sum(c.numel() for c in pc)
    if not moved <= TRAIN_FLIP_SHARE * total:
        raise AssertionError(f"[{label}] updated weights max|d| {max_d:.3e}, {moved} of "
                             f"{total} differ by more than 1e-6")
    if all(torch.equal(a, c) for a, c in zip(pg, p0)):
        raise AssertionError(f"[{label}] the step moved no weight")
    print(f"  loss rel {rel:.3e} (tol {TRAIN_LOSS_TOL:.0e}) ok; {len(gg)} gradients, worst rel L2 "
          f"{worst[0]:.3e} (tol {TRAIN_GRAD_TOL:.0e}) ok, {len(zero)} zero on both; updated "
          f"weights max|d| {max_d:.3e} (lr {learning_rate(0):.0e}), {moved} of {total} differ "
          f"by more than 1e-6 (<= {TRAIN_FLIP_SHARE:.0e} of them) ok")


def device_busy(prof, what: str) -> tuple[list, float]:
    """The device events of a torch.profiler capture and the device's busy
    time in us (``portbench.trace.union_us``: overlaps count once)."""
    import torch

    from portbench import trace

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError(f"torch.profiler recorded no device event in {what}")
    busy, _ = trace.union_us((e.time_range.start, e.time_range.end) for e in kernels)
    return kernels, busy


def inclusive_us(e) -> float:
    """An op's device time with its children's (the name moved across torch
    versions)."""
    return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)


def _split_step(tr, st, wav) -> dict:
    """torch.profiler over one step: the step's wall time; the device's busy
    time (the union of its kernels' intervals, so overlaps count once); the
    kernels' time by kind (products: cuBLAS; hand-written: K1/K2's; other:
    elementwise, reductions, copies) and the largest kernels; the device time
    inside the two named ranges (the trunk's weight recompute, its products
    included; Adam and the EMA)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import trace

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.step(st, wav)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels, busy = device_busy(prof, "a training step")
    kinds = {"products": 0.0, "hand-written": 0.0, "other": 0.0}
    by_name = {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        if trace.is_product(e.name):
            kinds["products"] += us
        elif trace.is_own(e.name):
            kinds["hand-written"] += us
        else:
            kinds["other"] += us
        by_name[e.name] = by_name.get(e.name, 0.0) + us

    ranges = {e.key: inclusive_us(e) / 1e3 for e in prof.key_averages()
              if e.key in ("trunk weight recompute", "adam and ema")}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return dict(wall_ms=wall, launches=len(kernels), busy_ms=busy / 1e3,
                kinds_ms={k: v / 1e3 for k, v in kinds.items()}, ranges_ms=ranges,
                top=[(n[:60], us / 1e3) for n, us in top])


def train_trunk_phase(dev, dtype_name: str) -> dict:
    """The trunk at the training step's geometry and type: 32 clips of 6144
    rows, init_params(0)'s trunk cast to the step's type, a cotangent on
    tap 29 alone, as in the step.
    (1) K1 and K2 layer by layer on the plain chain's own inputs, masks and
        cotangents, every 6144 rows a clip boundary (``chain_check``): TOL,
        MASK_TOL.
    (2) TrunkFunction (K1, K2 for dx, the weight gradients by recompute
        through reference_trunk) against autograd through reference_trunk
        alone: the weight gradients are the same recompute's, so equal. f32:
        tap 29 at TOL (max-relative), dx at TRAIN_GRAD_TOL (rel L2). bf16:
        both against the f32 autograd of the same values; the kernels' tap
        and dx no further from it than twice the plain bf16 autograd's (which
        rounds y to bf16 where K1 keeps it in f32) plus 1e-3, as the card test
        holds dx.
    (3) Each path's peak memory above its inputs, and its time (forward and
        backward, CUDA events, median of TRUNK_REPS after a warm-up).
    Returns the layer-by-layer K1 and K2 max|d|."""
    import torch

    from audio_style_transfer_tpu_torch.models.wavenet_ae import init_params
    from audio_style_transfer_tpu_torch.ops import chain

    label = f"train trunk {dtype_name}"
    dt = getattr(torch, dtype_name)
    tol = TOL[dtype_name]
    b, t = TRAIN_SHAPE
    gen = torch.Generator(device=dev).manual_seed(6)
    x = (torch.randn((b, t, C), generator=gen, device=dev) * 0.3).to(dt)
    ws = [w.to(dev, dt) for w in chain.stack_trunk_weights(init_params(0), LAYERS)]
    cot = torch.randn((b, t, C), generator=gen, device=dev).to(dt)
    dils = tuple(2 ** (j % 10) for j in range(LAYERS))

    print(f"[{label}] {b} x {t} rows, 30 layers, cotangent on tap 29:")
    wd, bd, wr, br = ws
    k1_err, k2_err, _, _ = chain_check("the training geometry", (wd, bd.float(), wr, br.float()),
                                       x.reshape(b * t, C), {LAYERS - 1: cot.reshape(b * t, C)},
                                       None, tol, clip_rows=t, wavefront=False)

    runs = (("kernels", chain.fused_trunk, dt), ("plain", chain.reference_trunk, dt))
    if dt != torch.float32:
        runs += (("f32", chain.reference_trunk, torch.float32),)
    taps, grads, peaks, ms = {}, {}, {}, {}
    for name, fn, run_dt in runs:
        xi = x.to(run_dt).requires_grad_(True)
        wi = [w.to(run_dt).requires_grad_(True) for w in ws]
        gi = cot.to(run_dt)

        def fwd_bwd():
            (tap,) = fn(xi, *wi, dils, (LAYERS - 1,))
            return tap, torch.autograd.grad(tap, [xi, *wi], gi)

        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        tap, g = fwd_bwd()
        torch.cuda.synchronize()
        peaks[name] = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
        taps[name], grads[name] = tap.detach(), g
        del tap, g
        if name != "f32":
            ms[name] = cuda_ms(fwd_bwd, reps=TRUNK_REPS, warmup=1)
        del xi, wi
    same = all(torch.equal(a, c) for a, c in zip(grads["kernels"][1:], grads["plain"][1:]))
    if not same:
        raise AssertionError(f"[{label}] the weight gradients are not the recompute's")
    _, tap_rel = rel_err(taps["kernels"], taps["plain"])
    dx_rel = float((grads["kernels"][0].float() - grads["plain"][0].float()).norm()
                   / grads["plain"][0].float().norm())
    if dt == torch.float32:
        ok = tap_rel <= tol and dx_rel <= TRAIN_GRAD_TOL
        how = (f"tap 29 max|d| rel {tap_rel:.2e} (tol {tol:.0e}), dx rel L2 {dx_rel:.2e} (tol "
               f"{TRAIN_GRAD_TOL:.0e})")
    else:
        ref_tap, ref_dx = taps["f32"], grads["f32"][0]
        tk, tp = (rel_err(taps[n], ref_tap)[1] for n in ("kernels", "plain"))
        dk, dp = (float((grads[n][0].float() - ref_dx).norm() / ref_dx.norm())
                  for n in ("kernels", "plain"))
        ok = tk <= 2 * tp + 1e-3 and dk <= 2 * dp + 1e-3
        how = (f"against the f32 autograd: tap 29 max|d| rel kernels {tk:.2e}, plain bf16 "
               f"{tp:.2e}; dx rel L2 kernels {dk:.2e}, plain bf16 {dp:.2e} (kernels <= 2 x plain "
               f"+ 1e-3); kernels against plain bf16: tap {tap_rel:.2e}, dx {dx_rel:.2e}")
    print(f"[{label}] TrunkFunction against plain autograd: weight gradients equal (the same "
          f"recompute); {how} {'ok' if ok else 'FAIL'}")
    print(f"[{label}] forward + backward: kernels + recompute {ms['kernels']:.1f} ms, plain "
          f"autograd {ms['plain']:.1f} ms (median of {TRUNK_REPS}); peak above the inputs: "
          f"kernels + recompute {peaks['kernels']:.2f} GB, plain autograd {peaks['plain']:.2f} GB")
    if not ok:
        raise AssertionError(f"[{label}] the trunk through K1/K2 disagrees with plain autograd")
    return dict(k1=k1_err, k2=k2_err)


def train_step_phase(dev, dtype_name: str, smi: str) -> dict:
    """(b) TrainConfig()'s step, 32 x 6144 samples, remat on, in float32 (the
    JAX default) or bfloat16 (compute_dtype: the tensor-core K1/K2, the
    decoder's bf16 products, its fused epilogues): one warm-up step, then
    steps timed by the host clock around each with a synchronize; exactly
    STEP_LAUNCHES per step; the loss falling over TRAIN_STEPS steps on one batch; peak
    memory; the split of one more step by torch.profiler."""
    import torch

    from audio_style_transfer_tpu_torch.models.wavenet_ae import WaveNetAEConfig
    from audio_style_transfer_tpu_torch.ops import _build
    from audio_style_transfer_tpu_torch.train import TrainConfig, Trainer
    from portbench import counts

    label = f"train step {dtype_name}"
    dtype = getattr(torch, dtype_name)
    b, t = TRAIN_SHAPE
    model_cfg = WaveNetAEConfig(compute_dtype=dtype)
    tr = Trainer(TrainConfig(save_every_steps=0), model_cfg, device=dev)
    st = tr.init_state()
    wav = torch.from_numpy(train_batch(TRAIN_SHAPE, 2)).to(dev)
    losses, ms, peaks = [], [], []
    want = {k: STEP_LAUNCHES[dtype_name].get(k, 0) for k in KERNELS}
    totals = {k: 0 for k in KERNELS}
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _build.reset_launches()
        t0 = time.perf_counter()
        st, loss = tr.step(st, wav)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        peaks.append(torch.cuda.max_memory_allocated(dev) / 1e9)
        if dict(_build.LAUNCHES) != want:
            raise AssertionError(f"[{label}] step {i} launched {dict(_build.LAUNCHES)}, want "
                                 f"{STEP_LAUNCHES[dtype_name]} and nothing else")
        for k, v in _build.LAUNCHES.items():
            totals[k] += v
        losses.append(float(loss))
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"[{label}] losses {losses}: not finite or not falling")
    timed = ms[1:]
    step_ms = float(np.median(timed))
    flops = counts.train_flops(b * t, vars(model_cfg))
    bnd = bound(0.0, flops, dtype_name)
    split = _split_step(tr, st, wav)
    busy = split["busy_ms"] / split["wall_ms"]
    print(f"[{label}] {b} x {t} samples, remat on, full width: {TRAIN_STEPS} steps on one "
          f"batch, losses {[round(v, 4) for v in losses]} (falling ok); launches per step "
          f"{STEP_LAUNCHES[dtype_name]}, the rest 0, every step ok")
    print(f"[{label}] step ms {[round(v, 1) for v in timed]} (median {step_ms:.1f}; the first, "
          f"with warm-up, {ms[0]:.1f}); {b * t / step_ms * 1e3:.0f} samples/s; bound "
          f"{bnd['bound_ms']:.1f} ms ({flops / 1e12:.2f} TFLOP over the {dtype_name} peak), "
          f"step / bound {step_ms / bnd['bound_ms']:.2f}; peak memory {max(peaks):.2f} GB "
          f"({smi})")
    kinds = ", ".join(f"{k} {v:.1f}" for k, v in split["kinds_ms"].items())
    ranges = ", ".join(f"{k} {v:.1f}" for k, v in split["ranges_ms"].items())
    top = "; ".join(f"{n} {v:.1f}" for n, v in split["top"])
    print(f"[{label}] one step under torch.profiler: {split['wall_ms']:.1f} ms wall, "
          f"{split['launches']} device operations, device busy {split['busy_ms']:.1f} ms (busy "
          f"share {busy:.3f}); device ms by kind: {kinds}; in the ranges: {ranges}; largest "
          f"kernels (ms): {top}")
    return dict(launches=totals, step_ms=step_ms, bound_ms=bnd["bound_ms"],
                peak_gb=max(peaks), busy=busy)


def train_fit_phase(dev) -> dict:
    """(c) ``fit`` over a synthetic TFRecord of 64000-sample examples through
    the native reader: a full group of ``steps_per_call`` batches and a
    trailing partial group; then save -> restore bit for bit, and an EMA
    ``evaluate`` that launches K1 30 times and K2 never."""
    import torch

    from audio_style_transfer_tpu_torch.data import NSynthDataset, build_example, write_tfrecord
    from audio_style_transfer_tpu_torch.ops import _build
    from audio_style_transfer_tpu_torch.train import TrainConfig, Trainer

    label = "train fit"
    totals = {k: 0 for k in KERNELS}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "nsynth.tfrecord")
        clips = train_batch((TRAIN_FIT_EXAMPLES, 64000), 3)
        write_tfrecord(path, [build_example({
            "note_str": f"synth-{i}".encode(), "pitch": np.array([40 + i], np.int64),
            "velocity": np.array([100], np.int64), "audio": clips[i],
            "qualities": np.zeros(10, np.int64), "instrument_source": np.array([0], np.int64),
            "instrument_family": np.array([i % 3], np.int64)}) for i in range(len(clips))])
        cfg = TrainConfig(**TRAIN_FIT, logdir=os.path.join(tmp, "log"), save_every_steps=0,
                          log_every_steps=TRAIN_FIT["steps_per_call"])
        tr = Trainer(cfg, device=dev)
        ds = NSynthDataset(path, is_training=True)
        batches = ds.get_wavenet_batch(cfg.total_batch_size, length=cfg.sample_length)
        logged = []
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        st = tr.fit(tr.init_state(), batches, num_steps=TRAIN_FIT_STEPS, log=logged.append)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fit_launches = dict(_build.LAUNCHES)
        for k, v in fit_launches.items():
            totals[k] += v
        if ds.reader_used != "native":
            raise AssertionError(f"[{label}] the {ds.reader_used} reader ran, not the native one")
        if st["step"] != TRAIN_FIT_STEPS or fit_launches["K1"] != LAYERS * TRAIN_FIT_STEPS \
                or fit_launches["K2"] != LAYERS * TRAIN_FIT_STEPS:
            raise AssertionError(f"[{label}] step {st['step']}, launches {fit_launches}")
        print(f"[{label}] {TRAIN_FIT_STEPS} steps of {cfg.total_batch_size} x "
              f"{cfg.sample_length} (groups of {cfg.steps_per_call}, then a partial group of "
              f"{TRAIN_FIT_STEPS % cfg.steps_per_call}) from {TRAIN_FIT_EXAMPLES} 64000-sample "
              f"examples through the {ds.reader_used} reader in {wall:.2f} s; log {logged}; "
              f"launches {fit_launches} ok")
        saved = tr.save(st)
        back = tr.restore()
        same = back["step"] == st["step"] and all(
            torch.equal(a, c) for a, c in zip(_train_leaves(st["params"]) + _train_leaves(st["ema"]),
                                              _train_leaves(back["params"]) + _train_leaves(back["ema"])))
        for p, q in zip(_train_leaves(st["params"]), _train_leaves(back["params"])):
            for key in ("exp_avg", "exp_avg_sq", "step"):
                same = same and torch.equal(st["opt_state"].state[p][key],
                                            back["opt_state"].state[q][key])
        if not same:
            raise AssertionError(f"[{label}] restore differs from the saved state")
        print(f"[{label}] save {os.path.basename(saved)} -> restore: params, EMA, Adam moments "
              "and step equal bit for bit ok")
        wav = train_batch((8, cfg.sample_length), 4)
        _build.reset_launches()
        nll = tr.evaluate(st, wav)
        ev = dict(_build.LAUNCHES)
        for k, v in ev.items():
            totals[k] += v
        want = {k: 0 for k in KERNELS}
        want.update(K1=LAYERS, gate_fwd=DECODER_LAYERS, residual_fwd=DECODER_LAYERS)
        if ev != want or not math.isfinite(nll):
            raise AssertionError(f"[{label}] evaluate: nll {nll}, launches {ev}")
        print(f"[{label}] EMA evaluate on 8 x {cfg.sample_length}: nll {nll:.4f}, launches "
              f"K1 {LAYERS}, gate_fwd and residual_fwd {DECODER_LAYERS}, the rest 0 ok")
    return totals


def train_cli_phase(dev) -> dict:
    """(d) cli/train.py as a subprocess for a few iterations on a synthetic
    TFRecord; its K1/K2 launches, which it prints, go into the kernels line."""
    label = "train cli"
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    from audio_style_transfer_tpu_torch.data import build_example, write_tfrecord

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train.tfrecord")
        clips = train_batch((4, 64000), 5)
        write_tfrecord(path, [build_example({"pitch": np.array([50 + i], np.int64),
                                             "audio": c}) for i, c in enumerate(clips)])
        args = [sys.executable, "-m", "audio_style_transfer_tpu_torch.cli.train",
                "--train_path", path, "--logdir", os.path.join(tmp, "log"),
                "--total_batch_size", str(TRAIN_CLI_BATCH), "--num_iters", str(TRAIN_CLI_ITERS),
                "--device", str(dev)]
        t0 = time.perf_counter()
        r = subprocess.run(args, cwd=here, env=env, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError(f"[{label}] failed:\n{r.stdout}\n{r.stderr[-3000:]}")
        m = re.search(r"saved (\S+) at step (\d+) \((\w+) reader\); kernel launches (\{.*\})",
                      r.stdout)
        if not m or int(m.group(2)) != TRAIN_CLI_ITERS or m.group(3) != "native":
            raise AssertionError(f"[{label}] unexpected output:\n{r.stdout}")
        launches = {k: 0 for k in KERNELS}
        launches.update(ast.literal_eval(m.group(4)))  # the dict the CLI printed
        if launches["K1"] != LAYERS * TRAIN_CLI_ITERS or launches["K2"] != LAYERS * TRAIN_CLI_ITERS:
            raise AssertionError(f"[{label}] launches {launches}")
        print(f"[{label}] {TRAIN_CLI_ITERS} iterations of {TRAIN_CLI_BATCH} x 6144 in {wall:.1f} s (process "
              f"start included): {os.path.basename(m.group(1))}, {m.group(3)} reader, launches "
              f"{{K1: {launches['K1']}, K2: {launches['K2']}}} ok")
    return launches


def train_phases(dev, smi: str) -> tuple[dict, dict]:
    """Every training phase: the K1/K2 launches of the main paths they ran,
    and K1/K2's layer-by-layer max|d| at the training geometry per type."""
    train_parity_phase(dev)
    totals = {k: 0 for k in KERNELS}
    rows, trunk = {}, {}
    for dtype_name in ("float32", "bfloat16"):
        trunk[dtype_name] = train_trunk_phase(dev, dtype_name)
        rows[dtype_name] = train_step_phase(dev, dtype_name, smi)
    for part in (*(r["launches"] for r in rows.values()), train_fit_phase(dev),
                 train_cli_phase(dev)):
        for k, v in part.items():
            totals[k] += v
    for dtype_name, r in rows.items():
        print(f"[train step {dtype_name}] median step {r['step_ms']:.1f} ms, bound "
              f"{r['bound_ms']:.1f} ms, ratio {r['step_ms'] / r['bound_ms']:.2f}, peak "
              f"{r['peak_gb']:.2f} GB, busy {r['busy']:.3f} ({smi})")
    return totals, trunk


# Data parallelism and clip sharding (parallel/mesh.py) on the one card: NCCL
# at world size 1 in this process, and 2 ranks that share the card over gloo
# (NCCL refuses two ranks on one card) in one spawned group.
DP_STEPS = 3
DP_GLOO_SHAPE = (4, 2048)  # the 2-rank step's global batch, f32: 2 x 2048 per rank
# The loss's rel, each step. The weights after the first step are held as the
# train parity phase holds them (TRAIN_FLIP_SHARE): Adam moves a weight by
# about lr whatever the size of its gradient, so where a gradient near zero
# differs between two sum orders (the whole batch at once, or a mean of the
# ranks' halves) the weights differ by a share of lr, not by a rounding
# error; every later step spreads such differences to more gradients.
DP_TOL = 1e-4
GLOO_RANKS = 2
CLIP_K, CLIP_EPOCHS, CLIP_MAXITER = 8, 2, 20  # clips of T at stack 0, bf16, fixed work
LONGFORM_TOL = (2e-4, 1e-4)  # sharded long-form audio: rtol, atol (tests/test_longform.py)
GLOO_DEADLINE_S = 900.0


def _step_launches(label: str, i: int, dtype_name: str) -> dict:
    """The launches of one training step, which must be STEP_LAUNCHES of its
    type."""
    from audio_style_transfer_tpu_torch.ops import _build

    want = {k: STEP_LAUNCHES[dtype_name].get(k, 0) for k in KERNELS}
    if dict(_build.LAUNCHES) != want:
        raise AssertionError(f"[{label}] step {i} launched {dict(_build.LAUNCHES)}, want "
                             f"{STEP_LAUNCHES[dtype_name]} and nothing else")
    return want


def dp_nccl_phase(dev, smi: str, mesh) -> dict:
    """[dp train nccl, world 1] ``Trainer(mesh=make_mesh(1))`` over NCCL against
    ``mesh=None``: TrainConfig()'s bf16 step at 32 x 6144 from the same weights
    on the same DP_STEPS batches, equal bit for bit (one rank's all-reduce and
    the division by 1 are exact); ms per step both ways, and the all-reduce of
    the flat float32 gradient buffer alone. Returns the launches."""
    import torch
    import torch.distributed as dist

    from audio_style_transfer_tpu_torch.models.wavenet_ae import WaveNetAEConfig
    from audio_style_transfer_tpu_torch.ops import _build
    from audio_style_transfer_tpu_torch.train import TrainConfig, Trainer
    from audio_style_transfer_tpu_torch.train.trainer import _leaves

    label = "dp train nccl, world 1"
    wavs = [torch.from_numpy(train_batch(TRAIN_SHAPE, 20 + i)).to(dev) for i in range(DP_STEPS)]
    cfg, model_cfg = TrainConfig(save_every_steps=0), WaveNetAEConfig(compute_dtype=torch.bfloat16)
    totals = {k: 0 for k in KERNELS}
    runs = {}
    for name, m in (("mesh=None", None), ("make_mesh(1)", mesh)):
        tr = Trainer(cfg, model_cfg, mesh=m, device=dev)
        st = tr.init_state()
        losses, ms = [], []
        for i, wav in enumerate(wavs):
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            st, loss = tr.step(st, wav)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            for k, v in _step_launches(label, i, "bfloat16").items():
                totals[k] += v
            losses.append(loss.detach())
        runs[name] = (torch.stack(losses).cpu(),
                      [p.detach().cpu() for p in _leaves(st["params"]) + _leaves(st["ema"])],
                      ms)
        del tr, st
    n_weights = sum(p.numel() for p in runs["mesh=None"][1]) // 2
    flat = torch.zeros(n_weights + 1, device=dev)
    reduce_ms = cuda_ms(lambda: dist.all_reduce(flat), reps=10)
    backend = dist.get_backend()
    del flat
    (l0, w0, ms0), (l1, w1, ms1) = runs.values()
    same = torch.equal(l0, l1) and all(torch.equal(a, b) for a, b in zip(w0, w1))
    print(f"[{label}] {backend}, {TRAIN_SHAPE[0]} x {TRAIN_SHAPE[1]} bf16, {DP_STEPS} steps: "
          f"losses {[round(float(v), 6) for v in l1]}; params and EMA equal mesh=None's bit for "
          f"bit: {'ok' if same else 'FAIL'}; launches per step {STEP_LAUNCHES['bfloat16']} ok")
    print(f"[{label}] ms per step (first with warm-up): mesh=None {[round(v, 1) for v in ms0]}, "
          f"make_mesh(1) {[round(v, 1) for v in ms1]}; all-reduce of the {n_weights} gradients "
          f"and the loss ({4 * (n_weights + 1) / 1e6:.1f} MB f32) alone {reduce_ms:.3f} ms "
          f"({smi})")
    if not same:
        raise AssertionError(f"[{label}] the world-1 mesh's state differs from mesh=None's")
    return totals


def _clip_inputs(engine) -> tuple:
    """CLIP_K content windows of T from one synthetic clip, and the style grams
    of CLIP_K windows of a synthetic style clip: (phi_cs, phi_ss) as numpy."""
    content = synth_audio(CLIP_K * T / 16000 + 0.1, kind="content")
    style = synth_audio(CLIP_K * T / 16000 + 0.1, kind="style")
    phi_cs = np.stack([engine.get_embeds(content[i * T:(i + 1) * T]) for i in range(CLIP_K)])
    phi_ss = np.stack([engine.get_embeds(style[i * T:(i + 1) * T], is_content=False)
                       for i in range(CLIP_K)])
    return phi_cs, phi_ss


def _clip_engine(dev):
    from audio_style_transfer_tpu_torch.models.wavenet_ae import WaveNetAEConfig, init_params
    from audio_style_transfer_tpu_torch.transfer.engine import StyleTransfer, TransferSpec

    spec = TransferSpec(stack=0, batch_size=T, epochs=CLIP_EPOCHS, maxiter=CLIP_MAXITER,
                        early_stop_evals=0, compute_dtype="bfloat16", write_artifacts=False,
                        device=str(dev))
    return StyleTransfer(spec, init_params(0, WaveNetAEConfig()))


def _longform_engine(dev):
    """The long-form cell's engine, as the CLI builds it for ``--longform
    --ot_components 8 --gamma 1e-3 --stack 0 --epochs 2 --precision bfloat16
    --fused --random_init``."""
    from audio_style_transfer_tpu_torch.models.wavenet_ae import WaveNetAEConfig, init_params
    from audio_style_transfer_tpu_torch.transfer.engine import StyleTransfer, TransferSpec

    spec = TransferSpec(stack=0, batch_size=T, epochs=2, gamma=1e-3, compute_dtype="bfloat16",
                        fused_encoder=True, write_artifacts=False, device=str(dev))
    return StyleTransfer(spec, init_params(0, WaveNetAEConfig()))


def _longform_clips() -> tuple:
    return (synth_audio((WINDOWS * T + 1000) / 16000, kind="content"),
            synth_audio(1.1, kind="style"))


def _timed_launches(fn):
    """(fn(), wall seconds, its launches), the device drained either side."""
    import torch

    from audio_style_transfer_tpu_torch.ops import _build

    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, dict(_build.LAUNCHES)


def gloo_rank(rank: int, tmp: str) -> None:
    """One of the GLOO_RANKS ranks of ``gloo_phases`` (spawned, gloo, on the one
    card): the DP steps, the clip-sharded batch, the sharded long-form run,
    the time-sharded exact evaluation and the tensor-parallel decoder, each
    started together after a barrier. Writes ``<tmp>/rank<r>.npz``."""
    import torch
    import torch.distributed as dist

    from audio_style_transfer_tpu_torch.ops import _build
    from audio_style_transfer_tpu_torch.parallel import make_mesh
    from audio_style_transfer_tpu_torch.train import TrainConfig, Trainer
    from audio_style_transfer_tpu_torch.train.trainer import _leaves
    from audio_style_transfer_tpu_torch.transfer.longform import transfer_longform

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(GLOO_RANKS, device="cuda", backend="gloo")
    dev = torch.device("cuda", torch.cuda.current_device())
    inp = np.load(os.path.join(tmp, "in.npz"))
    out = {}

    b, t = DP_GLOO_SHAPE
    tr = Trainer(TrainConfig(total_batch_size=b, sample_length=t, save_every_steps=0), mesh=mesh)
    st = tr.init_state()
    losses, ms, launches = [], [], {k: 0 for k in KERNELS}
    for i in range(DP_STEPS):
        dist.barrier()
        (st, loss), wall, _ = _timed_launches(
            lambda: tr.step(st, train_batch(DP_GLOO_SHAPE, 30 + i)))
        for k, v in _step_launches(f"dp train gloo, rank {rank}", i, "float32").items():
            launches[k] += v
        losses.append(float(loss))
        ms.append(wall * 1e3)
        if i == 0 and rank == 0:
            out["dp_params1"] = torch.cat([p.detach().reshape(-1)
                                           for p in _leaves(st["params"])]).cpu().numpy()
    flat = torch.cat([p.detach().reshape(-1) for p in _leaves(st["params"]) + _leaves(st["ema"])])
    mine = flat.clone()
    dist.broadcast(flat, src=0)
    out.update(dp_losses=np.array(losses), dp_ms=np.array(ms), dp_ranks_equal=np.array(
        bool(torch.equal(flat, mine))), dp_launches=np.array([launches[k] for k in KERNELS]))
    del tr, st, flat, mine

    engine = _clip_engine(dev)
    dist.barrier()
    res, wall, got = _timed_launches(
        lambda: engine.optimize_batch(inp["phi_cs"], inp["phi_ss"], mesh=mesh))
    out.update(clip_x=res["x"], clip_evals=res["evals"], clip_wall=np.array(wall),
               clip_launches=np.array([got[k] for k in KERNELS]))

    engine = _longform_engine(dev)
    content, style = _longform_clips()
    dist.barrier()
    res, wall, got = _timed_launches(lambda: transfer_longform(
        engine, content, style, ot_components=8, mesh=mesh, windows_per_device=1))
    out.update(lf_audio=res.audio, lf_evals=res.per_window["evals"], lf_wall=np.array(wall),
               lf_launches=np.array([got[k] for k in KERNELS]))
    del engine, res
    torch.cuda.empty_cache()

    out.update(exact_sharded_rank(rank, dev))
    out.update(tp_rank(dev))
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)


def gloo_phases(dev, smi: str) -> tuple[dict, dict]:
    """[dp train gloo, 2 ranks on one card], [clip sharded] and [longform
    sharded]: GLOO_RANKS spawned ranks over gloo on the one card (``gloo_rank``),
    each held to this process's single-rank run of the same work:
    - DP_STEPS f32 steps at full width on the global batch DP_GLOO_SHAPE
      against one Trainer on the whole batch: loss per step rel DP_TOL; after
      the first step at most TRAIN_FLIP_SHARE of the params differ by more
      than 1e-6; params and EMA after the last step equal on both ranks bit
      for bit; the float32 STEP_LAUNCHES per rank per step;
    - ``optimize_batch(mesh=)`` of CLIP_K clips (T, stack 0, bf16, CLIP_EPOCHS
      epochs of CLIP_MAXITER iterations, no early stop) against ``mesh=None``:
      max|d| stated (0 expected: each clip runs the same code on the same
      card), evaluations equal; aggregate evals/s both ways;
    - ``transfer_longform(mesh=, windows_per_device=1)`` on the long-form
      cell's clips (WINDOWS windows, OT target of 8 components) against
      ``mesh=None``: audio within LONGFORM_TOL, max|d| stated.
    Returns (runs entries (launches, evals, wall) for the evals/s summary, the
    training steps' launches)."""
    import torch

    from audio_style_transfer_tpu_torch.parallel.mesh import spawn
    from audio_style_transfer_tpu_torch.train import TrainConfig, Trainer, learning_rate
    from audio_style_transfer_tpu_torch.train.trainer import _leaves
    from audio_style_transfer_tpu_torch.transfer.longform import transfer_longform

    b, t = DP_GLOO_SHAPE
    tr = Trainer(TrainConfig(total_batch_size=b, sample_length=t, save_every_steps=0),
                 device=dev)
    st = tr.init_state()
    ref_losses, ref_ms = [], []
    for i in range(DP_STEPS):
        (st, loss), wall, _ = _timed_launches(
            lambda: tr.step(st, train_batch(DP_GLOO_SHAPE, 30 + i)))
        ref_losses.append(float(loss))
        ref_ms.append(wall * 1e3)
        if i == 0:
            ref_leaves = [p.detach().cpu() for p in _leaves(st["params"])]
    del tr, st
    engine = _clip_engine(dev)
    phi_cs, phi_ss = _clip_inputs(engine)
    clip_ref, clip_wall, clip_launches = _timed_launches(
        lambda: engine.optimize_batch(phi_cs, phi_ss))
    lf_engine = _longform_engine(dev)
    content, style = _longform_clips()
    lf_ref, lf_wall, lf_launches = _timed_launches(lambda: transfer_longform(
        lf_engine, content, style, ot_components=8))
    del engine, lf_engine
    ex_ref = {}
    for dtype_name in ("float32", "bfloat16"):
        engine = _exact_engine(dev, dtype_name)
        ex_ref[dtype_name] = [t.cpu() for t in exact_one_window_eval(engine)]
        del engine
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        np.savez(os.path.join(tmp, "in.npz"), phi_cs=phi_cs, phi_ss=phi_ss)
        t0 = time.perf_counter()
        spawn(gloo_rank, GLOO_RANKS, args=(tmp,), device="cuda", backend="gloo",
              deadline_s=GLOO_DEADLINE_S)
        spawn_s = time.perf_counter() - t0
        ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(GLOO_RANKS)]
    as_dict = lambda a: dict(zip(KERNELS, (int(v) for v in a)))  # noqa: E731

    label = "dp train gloo, 2 ranks on one card"
    loss_rel = max(abs(a - c) / abs(c) for a, c in zip(ranks[0]["dp_losses"], ref_losses))
    got, worst, moved, off = ranks[0]["dp_params1"], 0.0, 0, 0
    for ref in ref_leaves:
        d = np.abs(got[off:off + ref.numel()].reshape(ref.shape) - ref.numpy())
        off += ref.numel()
        worst = max(worst, float(d.max()))
        moved += int((d > 1e-6).sum())
    equal = all(bool(r["dp_ranks_equal"]) for r in ranks)
    print(f"[{label}] f32 full width, global batch {b} x {t}, {DP_STEPS} steps: losses "
          f"{[round(float(v), 6) for v in ranks[0]['dp_losses']]} against one process "
          f"{[round(v, 6) for v in ref_losses]}, worst rel {loss_rel:.2e} (tol {DP_TOL:.0e}); "
          f"params after step 1 against one process: max|d| {worst:.2e} (lr "
          f"{learning_rate(0):.0e}), {moved} of {off} differ by more than 1e-6 (<= "
          f"{TRAIN_FLIP_SHARE:.0e} of them); params and EMA after step {DP_STEPS} equal on "
          f"both ranks bit for bit: {'ok' if equal else 'FAIL'}; launches per rank per step "
          f"{STEP_LAUNCHES['float32']} ok")
    print(f"[{label}] ms per step (first with warm-up) by rank "
          f"{[[round(float(v), 1) for v in r['dp_ms']] for r in ranks]}, one process on the "
          f"whole batch {[round(v, 1) for v in ref_ms]} ({smi})")
    if not (loss_rel <= DP_TOL and moved <= TRAIN_FLIP_SHARE * off and equal):
        raise AssertionError(f"[{label}] disagrees with the single process")
    train_launches = {k: sum(as_dict(r["dp_launches"])[k] for r in ranks) for k in KERNELS}

    label = "clip sharded"
    evals = int(np.sum(clip_ref["evals"]))
    shard_launches = {k: sum(as_dict(r["clip_launches"])[k] for r in ranks) for k in KERNELS}
    d = max(float(np.abs(r["clip_x"] - clip_ref["x"]).max()) for r in ranks)
    same_evals = all(np.array_equal(r["clip_evals"], clip_ref["evals"]) for r in ranks)
    shard_wall = max(float(r["clip_wall"]) for r in ranks)
    print(f"[{label}] {CLIP_K} clips of {T}, stack 0, bf16, {CLIP_EPOCHS} epochs of maxiter "
          f"{CLIP_MAXITER}: {GLOO_RANKS} gloo ranks on one card against mesh=None: x max|d| "
          f"{d:.3e}, evaluations equal {'ok' if same_evals else 'FAIL'} ({evals}); "
          f"aggregate {evals / clip_wall:.1f} evals/s in one process ({clip_wall:.2f} s), "
          f"{evals / shard_wall:.1f} evals/s over {GLOO_RANKS} ranks ({shard_wall:.2f} s, "
          f"the slower rank), ratio {clip_wall / shard_wall:.2f} ({smi})")
    scale = float(np.abs(clip_ref["x"]).max())
    if not (same_evals and d <= 1e-3 * scale):
        raise AssertionError(f"[{label}] the sharded batch differs from mesh=None's")
    check_launches(f"{label}, {GLOO_RANKS} ranks", shard_launches, {"K1", "K2", "K5", "K6"},
                   evals)
    check_launches(f"{label}, mesh=None", clip_launches, {"K1", "K2", "K5", "K6"}, evals)

    label = "longform sharded"
    lf_evals = int(np.sum(lf_ref.per_window["evals"]))
    lf_shard = {k: sum(as_dict(r["lf_launches"])[k] for r in ranks) for k in KERNELS}
    d = max(float(np.abs(r["lf_audio"] - lf_ref.audio).max()) for r in ranks)
    ok = all(np.allclose(r["lf_audio"], lf_ref.audio, rtol=LONGFORM_TOL[0], atol=LONGFORM_TOL[1])
             for r in ranks)
    lf_shard_wall = max(float(r["lf_wall"]) for r in ranks)
    print(f"[{label}] {WINDOWS} windows, OT 8 components, gamma 1e-3, stack 0, bf16, 2 epochs, "
          f"windows_per_device=1 over {GLOO_RANKS} gloo ranks against mesh=None: audio max|d| "
          f"{d:.3e} (rtol {LONGFORM_TOL[0]:.0e}, atol {LONGFORM_TOL[1]:.0e}) "
          f"{'ok' if ok else 'FAIL'}; evals by window {ranks[0]['lf_evals'].sum(axis=1).tolist()}"
          f" against {lf_ref.per_window['evals'].sum(axis=1).tolist()}; wall {lf_wall:.2f} s "
          f"in one process, {lf_shard_wall:.2f} s over {GLOO_RANKS} ranks (setup included); "
          f"the spawned group took {spawn_s:.1f} s with process start ({smi})")
    if not ok:
        raise AssertionError(f"[{label}] the sharded audio differs from mesh=None's")
    shard_lf_evals = int(np.sum(ranks[0]["lf_evals"]))
    check_launches(f"{label}, {GLOO_RANKS} ranks", lf_shard, {"K1", "K2", "K5", "K6"},
                   shard_lf_evals)
    label = "exact sharded gloo, 2 ranks on one card"
    ex_launches = {k: sum(as_dict(r["ex_launches"])[k] for r in ranks) for k in KERNELS}
    ex_evals = 2 * (1 + EXACT_GLOO_TIMED)  # evaluations of the whole clip, each over both ranks
    for dtype_name, (f_ref, g_ref) in ex_ref.items():
        loss_tol, grad_tol = EXACT_TOL[dtype_name]
        print(f"[{label}] {dtype_name}, {EXACT_SHARDED_T} samples in chunks of "
              f"{EXACT_SHARDED_T // GLOO_RANKS}: first evaluation by rank "
              f"{[float(r[f'ex_{dtype_name}_f']) for r in ranks]} against one window in one "
              f"process {float(f_ref):.6f}; ms per evaluation by rank (first with warm-up) "
              f"{[[round(float(v), 1) for v in r[f'ex_{dtype_name}_ms']] for r in ranks]}")
        for r in ranks:
            check("loss, sharded against one window", torch.tensor(r[f"ex_{dtype_name}_f"]),
                  f_ref, loss_tol)
            check("waveform gradient gathered, sharded against one window",
                  torch.from_numpy(r[f"ex_{dtype_name}_g"])[None], g_ref, grad_tol)
    print(f"[{label}] launches per rank per evaluation {EVAL_LAUNCHES} ok ({ex_launches} in "
          f"all: {ex_evals} evaluations of the clip, each on {GLOO_RANKS} ranks); halo exchange "
          f"of 2 x 3072 f32 samples "
          f"{[round(float(r['ex_halo_ms']), 3) for r in ranks]} ms, all-reduce of the gram "
          f"({C} x 10 x 10 f32) {[round(float(r['ex_gram_ms']), 3) for r in ranks]} ms, of a "
          f"scalar {[round(float(r['ex_scalar_ms']), 3) for r in ranks]} ms, by rank ({smi})")

    run_launches = {k: sum(as_dict(r["ex_run_launches"])[k] for r in ranks) for k in KERNELS}
    run_evals = int(ranks[0]["ex_run_evals"])
    run_wall = max(float(r["ex_run_wall"]) for r in ranks)
    same = len({float(r["ex_run_loss"]) for r in ranks}) == 1 and all(
        int(r["ex_run_evals"]) == run_evals for r in ranks)
    print(f"[{label}] transfer_exact(mesh=) bf16, 2 epochs: {run_evals} evaluations and final "
          f"loss {float(ranks[0]['ex_run_loss']):.4f} on every rank "
          f"{'ok' if same else 'FAIL'}; {run_wall:.2f} s ({smi})")
    if not same:
        raise AssertionError(f"[{label}] the ranks' transfer_exact runs differ")

    label = "tp decoder gloo, 2 ranks"
    for i, r in enumerate(ranks):
        err = dict(zip(("logits", "gradients", "nll"), (float(v) for v in r["tp_err"])),
                   worst=str(r["tp_worst"]))
        check_tp(f"{label}, rank {i}", err, float(r["tp_ms"]), float(r["tp_ref_ms"]), smi)
    if not all(bool(r["tp_ranks_equal"]) for r in ranks):
        raise AssertionError(f"[{label}] the ranks' gradients differ")
    print(f"[{label}] the ranks' gradients equal bit for bit ok")

    runs = {
        "clip sharded, mesh=None": (clip_launches, evals, clip_wall),
        f"clip sharded, {GLOO_RANKS} ranks": (shard_launches, evals, shard_wall),
        "longform sharded, mesh=None": (lf_launches, lf_evals, lf_wall),
        f"longform sharded, {GLOO_RANKS} ranks": (lf_shard, shard_lf_evals, lf_shard_wall),
        f"exact sharded gloo, {GLOO_RANKS} ranks": (ex_launches, ex_evals, max(
            sum(float(np.sum(r[f"ex_{d}_ms"])) for d in ex_ref) for r in ranks) / 1e3),
        f"exact sharded gloo, {GLOO_RANKS} ranks, transfer_exact": (run_launches, run_evals,
                                                                   run_wall),
    }
    return runs, train_launches


# Time sharding and the tensor-parallel decoder (parallel/halo.py,
# parallel/tensor.py) on the one card: NCCL at world size 1 in this process,
# and in the spawned group of 2 gloo ranks (gloo_rank).
EXACT_SHARDED_T = (EXACT_SAMPLES // 4096) * 4096  # the one-window clip; splits over 1 or 2 ranks
EVAL_LAUNCHES = {"K1": LAYERS, "K2": LAYERS, "K5": 1, "K6": 1}  # one evaluation of a rank's chunk
TP_SHAPE = (4, 6144)  # the tensor-parallel decoder's batch, f32, TF32 off
TP_TIMED = 2  # timed forward + backward passes after one warm-up
# The decoder's logits and each parameter's gradient, tensor-parallel against
# decode_logits in one process: max|d| over the reference's largest entry.
# f32 products over 30 layers summed in another order (the fused res + skip
# product, the ranks' partial products added by the all-reduce): about
# 2.4e-6 a product of 1536 terms, grown through the residual stream; 10x
# that margin and more for the gradients, whose small entries move most.
TP_TOL = {"logits": 1e-4, "gradients": 1e-3}
COLLECTIVE_REPS = 10
EXACT_GLOO_TIMED = 3  # evaluations timed after the first on each gloo rank


def _exact_engine(dev, dtype_name: str):
    """The exact long-form engine of ``[exact, ...]``: full width, seed-0
    weights, stack 0, gamma 1e-3, the chained kernels, 2 epochs."""
    from audio_style_transfer_tpu_torch.models.wavenet_ae import WaveNetAEConfig, init_params
    from audio_style_transfer_tpu_torch.transfer.engine import StyleTransfer, TransferSpec

    spec = TransferSpec(stack=0, gamma=1e-3, epochs=2, compute_dtype=dtype_name,
                        fused_encoder=True, write_artifacts=False, device=str(dev))
    return StyleTransfer(spec, init_params(0, WaveNetAEConfig()))


def exact_one_window_eval(engine) -> tuple:
    """(loss, waveform gradient) of the one-window flavour's first evaluation
    on the first EXACT_SHARDED_T samples of the 15 s clip."""
    t = EXACT_SHARDED_T
    vg, params, x, phi_c, phi_s = exact_first_eval(engine, t, t, t)
    return vg(params, x, phi_c, phi_s)


def exact_sharded_eval(engine, mesh, axis: str) -> tuple:
    """(vg, x at 1e-6) of the time-sharded exact loss on the rank's chunk of
    the clip of ``exact_one_window_eval``: the content target from the
    sharded embeds pass, the style target the style clip's statistics, as
    ``exact_first_eval`` makes them. ``vg(x)`` -> (loss, the chunk's
    gradient)."""
    import torch

    from audio_style_transfer_tpu_torch.parallel import halo
    from audio_style_transfer_tpu_torch.parallel.mesh import shard_rows
    from audio_style_transfer_tpu_torch.signal.mu_law import mu_law_numpy

    content = synth_audio(EXACT_SAMPLES / 16000, kind="content")[:EXACT_SHARDED_T]
    xq = engine._tensor(shard_rows(mesh, mu_law_numpy(content[None]), axis, dim=1))
    phi_s = engine._tensor(engine.get_style_phi(synth_audio(3.0, kind="style")))
    geometry = (engine.cfg, engine.loss_spec, mesh, axis)
    with torch.no_grad():
        phi_c = halo.make_sharded_embeds_fn(*geometry)(engine.params, xq)[0].to(torch.float32)
    loss_fn = halo.make_sharded_loss_fn(*geometry)

    def vg(x):
        xv = x.detach().requires_grad_(True)
        loss = loss_fn(engine.params, xv, phi_c, phi_s)
        return loss.detach(), torch.autograd.grad(loss, xv)[0]

    return vg, torch.full_like(xq, 1e-6)


def check_eval_launches(label: str, launches: dict) -> None:
    """One evaluation of a rank's chunk launched EVAL_LAUNCHES and nothing else."""
    want = {k: EVAL_LAUNCHES.get(k, 0) for k in KERNELS}
    if launches != want:
        raise AssertionError(f"[{label}] one evaluation launched {launches}, want {want}")


def host_ms(fn, reps: int = COLLECTIVE_REPS) -> float:
    """Median ms of fn() by the host clock, the device drained either side
    (a collective over gloo runs on the host)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def exact_sharded_run(engine, mesh, label: str) -> tuple:
    """``transfer_exact(mesh=)`` on the 15 s clip (2 epochs): losses falling,
    the audio the mesh's trimmed length, every launch accounted for (per
    evaluation EVAL_LAUNCHES; gradient-free, the engine windows of style
    statistics and one sharded embeds pass); ms per evaluation in L-BFGS
    and peak memory. Returns (launches, evals, wall seconds, final loss)."""
    import torch

    from audio_style_transfer_tpu_torch.transfer import longform

    quantum = 512 * mesh.size(0)
    t_total = (EXACT_SAMPLES // quantum) * quantum
    content = synth_audio(EXACT_SAMPLES / 16000, kind="content")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with lbfgs_clock() as in_lbfgs:
        res, wall, launches = _timed_launches(lambda: longform.transfer_exact(
            engine, content, synth_audio(3.0, kind="style"), mesh=mesh))
    peak = torch.cuda.max_memory_allocated()
    per = res.per_window
    losses = [float(v) for v in per["metrics"]]
    evals = int(np.sum(per["evals"]))
    check_losses(label, losses, res.audio, samples=t_total)
    if per["t_optimized"] != t_total or per["x"].shape != (1, t_total):
        raise AssertionError(f"[{label}] optimized {per['t_optimized']} samples, expected "
                             f"{t_total}")
    # Gradient-free passes: the style statistics' engine windows (at most 5
    # of T each, of the content and of the style clip) and the sharded embeds.
    passes = sum(min(n, 5 * T) // T for n in (EXACT_SAMPLES, 48000)) + 1
    want = {k: 0 for k in KERNELS}
    want.update(K1=LAYERS * (evals + passes), K2=LAYERS * evals, K5=evals + passes, K6=evals)
    if launches != want:
        raise AssertionError(f"[{label}] launches {launches} for {evals} evaluations, expected "
                             f"{want}")
    # flush: the gloo ranks print here too, each line in one write
    print(f"[{label}] launches {launches} == per evaluation K1 30, K2 30, K5 1, K6 1, plus "
          f"{passes} gradient-free passes ok", flush=True)
    print(f"[{label}] {per['epochs_done']} epochs, evals {per['evals'].tolist()}, losses {losses}; "
          f"t_optimized {t_total}; {evals} evals in {wall:.2f} s wall ({evals / wall:.2f} "
          f"evals/s, setup included), {1e3 * in_lbfgs[0] / evals:.3f} ms per eval in L-BFGS; "
          f"peak memory {peak / 2**30:.3f} GiB", flush=True)
    return launches, evals, wall, losses[-1]


def exact_sharded_nccl_phase(dev, smi: str) -> dict:
    """[exact sharded nccl, world 1] ``transfer_exact(mesh=make_mesh(1))`` (NCCL,
    world size 1: the halos zeros, the windowed K1/K2 on (radius, chunk +
    radius), one rank's all-reduces) in float32 and bfloat16: the first
    evaluation's loss and gradient against the one-window flavour at
    EXACT_TOL (the same kernels on the same valid rows, the grams summed
    over other tiles), with its launches, then the 2-epoch run. Returns the
    runs' entries (launches, evals, wall, final loss)."""
    import torch

    from audio_style_transfer_tpu_torch.parallel import make_mesh

    mesh = make_mesh(1, axis_name="time")
    runs = {}
    for dtype_name in ("float32", "bfloat16"):
        label = f"exact sharded nccl, world 1, {dtype_name}"
        engine = _exact_engine(dev, dtype_name)
        f1, g1 = exact_one_window_eval(engine)
        vg, x = exact_sharded_eval(engine, mesh, "time")
        (f2, g2), wall, launches = _timed_launches(lambda: vg(x))
        check_eval_launches(label, launches)
        loss_tol, grad_tol = EXACT_TOL[dtype_name]
        print(f"[{label}] first evaluation on {EXACT_SHARDED_T} samples: one window "
              f"{float(f1):.6f}, sharded {float(f2):.6f} ({1e3 * wall:.1f} ms); launches "
              f"{launches} ok")
        check("loss, sharded against one window", f2, f1, loss_tol)
        check("waveform gradient, sharded against one window", g2, g1, grad_tol)
        runs[label] = exact_sharded_run(engine, mesh, label)
        del engine, vg, x, g1, g2
        torch.cuda.empty_cache()
    return runs


def tp_inputs(dev) -> tuple:
    """The full-width decoder's seed-0 weights on the card, TP_SHAPE mu-law
    samples and a random encoding [B, T / 512, 16]."""
    import torch

    from audio_style_transfer_tpu_torch.models.wavenet_ae import WaveNetAEConfig, init_params
    from audio_style_transfer_tpu_torch.signal.mu_law import mu_law_numpy

    params = {k: {m: v.to(dev) for m, v in e.items()}
              for k, e in init_params(0, WaveNetAEConfig()).items() if not k.startswith("ae_")}
    b, t = TP_SHAPE
    xq = torch.from_numpy(mu_law_numpy(train_batch(TP_SHAPE, 40)).astype(np.float32)).to(dev)
    enc = np.random.RandomState(41).randn(b, t // 512, 16).astype(np.float32)
    return params, xq, torch.from_numpy(enc).to(dev)


def tp_step(decode, params, xq, enc, fused: bool) -> tuple:
    """(logits, the NLL, the gradients of params' leaves, median ms) of the NLL
    forward + backward through ``decode(params, xq, enc)``, TP_TIMED passes
    timed after one warm-up; the outputs of the last. Launches of the
    hand-written kernels: with ``fused`` (``decode_logits``) each of the
    decoder's four epilogue kernels once a block a pass, else none
    (``tp_decode_logits`` runs ``ops.conv`` and its own block code)."""
    import torch

    from audio_style_transfer_tpu_torch.models.wavenet_ae import nll_loss
    from audio_style_transfer_tpu_torch.ops import _build

    leaves = [v.requires_grad_(True) for e in params.values() for v in e.values()]
    _build.reset_launches()
    ms = []
    for i in range(TP_TIMED + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = decode(params, xq, enc)
        nll = nll_loss(logits, xq)
        grads = torch.autograd.grad(nll, leaves, allow_unused=True)
        torch.cuda.synchronize()
        if i:
            ms.append((time.perf_counter() - t0) * 1e3)
    per_pass = DECODER_LAYERS * (TP_TIMED + 1) if fused else 0
    want = {k: per_pass if k in ("gate_fwd", "gate_bwd", "residual_fwd", "residual_bwd") else 0
            for k in KERNELS}
    if dict(_build.LAUNCHES) != want:
        raise AssertionError(f"the decoder launched {dict(_build.LAUNCHES)}, want {want}")
    # The last layer's residual output feeds nothing: res_30 has no gradient.
    grads = [torch.zeros_like(v) if g is None else g.detach() for g, v in zip(grads, leaves)]
    return logits.detach(), float(nll.detach()), grads, float(np.median(ms))


def tp_errors(got, ref, params) -> dict:
    """The tensor-parallel pass against ``decode_logits``: logits and the worst
    gradient (and its weight's name) as max|d| over the reference's largest
    entry, the NLL's rel."""
    names = [f"{layer}/{k}" for layer, e in params.items() for k in e]
    rels = [rel_err(a, b)[1] for a, b in zip(got[2], ref[2])]
    worst = int(np.argmax(rels))
    return {"logits": rel_err(got[0], ref[0])[1], "gradients": rels[worst],
            "nll": abs(got[1] - ref[1]) / abs(ref[1]), "worst": names[worst]}


def check_tp(label: str, err: dict, ms: float, ref_ms: float, smi: str) -> None:
    ok = all(err[k] <= TP_TOL[k] for k in TP_TOL)
    b, t = TP_SHAPE
    print(f"[{label}] full-width decoder, {b} x {t}, f32: logits max|d| rel {err['logits']:.3e} "
          f"(tol {TP_TOL['logits']:.0e}), worst parameter gradient {err['gradients']:.3e} (tol "
          f"{TP_TOL['gradients']:.0e}; {err['worst']}), NLL rel {err['nll']:.2e} against "
          f"decode_logits in one process {'ok' if ok else 'FAIL'}; NLL forward + backward "
          f"{ms:.1f} ms, decode_logits {ref_ms:.1f} ms ({smi})")
    if not ok:
        raise AssertionError(f"[{label}] disagrees with decode_logits")


def tp_nccl_phase(dev, smi: str) -> None:
    """[tp decoder nccl, world 1] ``tp_decode_logits`` over ``make_mesh(1)``
    (NCCL; the fused res + skip product, one rank's all-reduces and
    gathers) against ``decode_logits``: logits and every decoder weight's
    gradient at TP_SHAPE, ms of both."""
    import torch

    from audio_style_transfer_tpu_torch.models.wavenet_ae import WaveNetAEConfig, decode_logits
    from audio_style_transfer_tpu_torch.parallel import make_mesh, tp_decode_logits

    mesh, cfg = make_mesh(1, axis_name="model"), WaveNetAEConfig()
    params, xq, enc = tp_inputs(dev)
    ref = tp_step(lambda p, x, e: decode_logits(p, x, e, cfg), params, xq, enc, True)
    got = tp_step(lambda p, x, e: tp_decode_logits(p, x, e, cfg, mesh), params, xq, enc, False)
    check_tp("tp decoder nccl, world 1", tp_errors(got, ref, params), got[3], ref[3], smi)
    del params, ref, got
    torch.cuda.empty_cache()


def exact_sharded_rank(rank: int, dev) -> dict:
    """A gloo rank's part of [exact sharded gloo, 2 ranks on one card]: per
    type, the sharded evaluation at 1e-6, its launches checked per
    evaluation, the first one's loss and gathered gradient, EXACT_GLOO_TIMED
    more timed; in bf16 then ``transfer_exact(mesh=)`` itself
    (``exact_sharded_run``: 2 epochs, the rank's launches printed and
    checked); the halo exchange and the all-reduces of the gram and of a
    scalar timed alone."""
    import torch
    import torch.distributed as dist

    from audio_style_transfer_tpu_torch.parallel import halo, make_mesh
    from audio_style_transfer_tpu_torch.parallel.mesh import gather_rows, neighbour_exchange, psum

    mesh = make_mesh(GLOO_RANKS, axis_name="time", device=dev.type, backend="gloo")
    group = mesh.get_group("time")
    out, launches = {}, {k: 0 for k in KERNELS}
    for dtype_name in ("float32", "bfloat16"):
        engine = _exact_engine(dev, dtype_name)
        radius = halo._window_radius(engine.cfg)
        vg, x = exact_sharded_eval(engine, mesh, "time")
        walls = []
        for i in range(1 + EXACT_GLOO_TIMED):
            dist.barrier()
            (f, g), wall, got = _timed_launches(lambda: vg(x))
            check_eval_launches(f"exact sharded gloo, rank {rank}", got)
            launches = {k: launches[k] + got[k] for k in KERNELS}
            walls.append(wall * 1e3)
            if i == 0:
                out[f"ex_{dtype_name}_f"] = np.array(float(f))
                out[f"ex_{dtype_name}_g"] = gather_rows(mesh, g[0].cpu().numpy(), "time")
        out[f"ex_{dtype_name}_ms"] = np.array(walls)
        if dtype_name == "bfloat16":
            dist.barrier()
            got, evals, wall, loss = exact_sharded_run(
                engine, mesh, f"exact sharded gloo, rank {rank}, bfloat16")
            out.update(ex_run_launches=np.array([got[k] for k in KERNELS]),
                       ex_run_evals=np.array(evals), ex_run_wall=np.array(wall),
                       ex_run_loss=np.array(loss))
        del engine, vg, g
    gram = torch.zeros((C, len(STYLE), len(STYLE)), device=dev)
    out.update(ex_launches=np.array([launches[k] for k in KERNELS]),
               ex_halo_ms=np.array(host_ms(lambda: neighbour_exchange(
                   group, x[:, :radius], x[:, -radius:]))),
               ex_gram_ms=np.array(host_ms(lambda: psum(gram, group))),
               ex_scalar_ms=np.array(host_ms(lambda: psum(gram[0, 0, 0], group))))
    del x, gram
    torch.cuda.empty_cache()
    return out


def tp_rank(dev) -> dict:
    """A gloo rank's part of [tp decoder gloo, 2 ranks]: ``tp_decode_logits``
    against its own ``decode_logits`` pass, the errors, both ms, and whether
    the ranks' gradients are equal bit for bit."""
    import torch
    import torch.distributed as dist

    from audio_style_transfer_tpu_torch.models.wavenet_ae import WaveNetAEConfig, decode_logits
    from audio_style_transfer_tpu_torch.parallel import make_mesh, tp_decode_logits

    mesh, cfg = make_mesh(GLOO_RANKS, axis_name="model", device=dev.type, backend="gloo"), \
        WaveNetAEConfig()
    params, xq, enc = tp_inputs(dev)
    ref = tp_step(lambda p, xx, e: decode_logits(p, xx, e, cfg), params, xq, enc, True)
    dist.barrier()
    got = tp_step(lambda p, xx, e: tp_decode_logits(p, xx, e, cfg, mesh), params, xq, enc,
                  False)
    err = tp_errors(got, ref, params)
    flat = torch.cat([g.reshape(-1) for g in got[2]])
    mine = flat.clone()
    dist.broadcast(flat, src=0)
    return dict(tp_err=np.array([err[k] for k in ("logits", "gradients", "nll")]),
                tp_worst=np.array(err["worst"]),
                tp_ms=np.array(got[3]), tp_ref_ms=np.array(ref[3]),
                tp_ranks_equal=np.array(bool(torch.equal(flat, mine))))


def nccl_world1_phases(dev, smi: str) -> tuple:
    """The world-size-1 NCCL phases in one process group: [dp train nccl,
    world 1], [exact sharded nccl, world 1] and [tp decoder nccl, world 1].
    Returns (the training steps' launches, the exact runs' entries)."""
    import torch.distributed as dist

    from audio_style_transfer_tpu_torch.parallel import make_mesh

    try:
        dp_launches = dp_nccl_phase(dev, smi, make_mesh(1))
        exact_runs = exact_sharded_nccl_phase(dev, smi)
        tp_nccl_phase(dev, smi)
    finally:
        dist.destroy_process_group()
    return dp_launches, exact_runs


# The side-car slice (ROADMAP M9): the baseline spectral AE's training and
# embedding CLIs at the nfft_1024 geometry, its spectrogram features and
# Griffin-Lim, the CQT, and the gram-figure CLI's per-window grams. The
# baseline model is cuDNN convs (XLA ops in JAX, no Pallas kernel) in float32
# with TF32 off; the grams run K1 and K5.
BASELINE_EXAMPLES = 16  # 64000-sample examples in the synthetic TFRecord
BASELINE_BATCH = 8  # BaselineHParams()'s batch
BASELINE_CLI_ITERS = 12
BASELINE_STEPS = 10  # in-process steps on one batch; the first 2 are warm-up
BASELINE_WARMUP = 2
BASELINE_SHALLOW = dict(  # card against CPU: tests/test_baseline_ae.py's spec
    num_latent=8, pitch_embedding_dim=8, n_fft=64,
    encoder_spec=(((5, 5), (2, 2), 16), ((4, 4), (2, 2), 16), ((4, 4), (2, 2), 32)),
    decoder_spec=(((4, 4), (2, 2), 32), ((4, 4), (2, 2), 16), ((5, 5), (2, 2), 16)))
# f32 card against CPU after one step, TF32 off: the loss 1e-5 relative;
# each gradient 1e-4 of its largest entry (cuDNN's sums in other orders),
# except the biases before a training-mode BN, whose gradients are rounding
# noise (zero in exact arithmetic); the BN running statistics 1e-5.
BASELINE_LOSS_TOL = 1e-5
BASELINE_GRAD_TOL = 1e-4
BASELINE_BN_TOL = 1e-5
BASELINE_Z_TOL = 1e-5  # the CLI's z against this process's encode: cuDNN in two processes
# dB features in [0, 1], cuFFT against the CPU's FFT: an FFT's float32 error
# is about 1e-7 of the clip's peak, so a bin's feature moves by that over the
# bin's magnitude: 1e-4 within 60 dB of the peak (feature >= 0.5), and up to
# 1e-2 below (0.9 dB at the -120 dB floor, where the error is 10% of the bin).
SPEC_TOL = 1e-4
SPEC_FLOOR_TOL = 1e-2
GL_ITERS = 1000  # the reference's Griffin-Lim iterations (ispecgram's default)
GL_CHECK_ITERS = 20
GL_TOL = 1e-3  # 20 projections card vs CPU from one phase, of the audio's peak
CQT_SECONDS = 4.0
CQT_TOL = 1e-5  # card vs the port's CPU CQT: 16384-term float32 sums, TF32 off
GRAMS_WINDOWS = 3
GRAMS_TOL = 1e-4  # the f32 K1 chain + K5 against the plain trunk + einsum, of the max


def baseline_flops(hp, batch: int) -> tuple[float, list]:
    """Operations (2 per multiply-add) of one forward of the baseline AE from
    its layer shapes, and each conv's share: a conv does out_h out_w cout cin
    kh kw multiply-adds; a transposed conv in_h in_w cin cout kh kw (each input
    pixel meets the whole kernel once: no work on the stride's zeros)."""
    h, w, cin = 512, 256, 1
    rows = []
    for (kh, kw), (sh, sw), cout in hp.enc_layers:
        h, w = -(-h // sh), -(-w // sw)
        rows.append(("conv", h * w * cout * cin * kh * kw))
        cin = cout
    rows.append(("conv", h * w * hp.num_latent * cin))
    cin = hp.num_latent + hp.pitch_embedding_dim
    for (kh, kw), (sh, sw), cout in hp.dec_layers:
        rows.append(("transposed conv", h * w * cin * cout * kh * kw))
        h, w, cin = h * sh, w * sw, cout
    rows.append(("conv", h * w * cin))
    total = 2.0 * batch * sum(r[1] for r in rows)
    return total, [(kind, 2.0 * batch * n / total) for kind, n in rows]


def write_baseline_records(path: str) -> None:
    """Synthetic NSynth examples: 64000 samples of tones and noise each, keyed
    and pitched (no NSynth data ships with the repository)."""
    from audio_style_transfer_tpu_torch.data import build_example, write_tfrecord

    clips = train_batch((BASELINE_EXAMPLES, 64000), 11)
    write_tfrecord(path, [build_example({
        "note_str": f"synth-{i:02d}".encode(), "pitch": np.array([36 + 3 * i], np.int64),
        "velocity": np.array([100], np.int64), "audio": clips[i],
        "qualities": np.zeros(10, np.int64), "instrument_source": np.array([0], np.int64),
        "instrument_family": np.array([i % 3], np.int64)}) for i in range(len(clips))])


def run_cli(label: str, module: str, args: list) -> tuple[str, float]:
    """``python -m module args`` from the checkout; its stdout and wall."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", module, *args], cwd=here, env=env,
                       capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"[{label}] failed:\n{r.stdout}\n{r.stderr[-3000:]}")
    return r.stdout, wall


def baseline_parity_phase(dev) -> None:
    """One step at the shallow geometry, card against CPU from the same
    weights and batch: the loss, every gradient, the updated BN statistics."""
    import torch

    from audio_style_transfer_tpu_torch.models import baseline_ae as tb

    label = "baseline parity"
    hp = tb.BaselineHParams(**BASELINE_SHALLOW)
    rng = np.random.RandomState(0)
    spec = torch.tensor(rng.rand(2, 32, 16, 1).astype(np.float32))
    pitch = torch.tensor([60, 64])
    out = {}
    for where in ("cpu", str(dev)):
        model = tb.BaselineAE(hp, seed=1).to(where)
        loss = tb.train_step(model, tb.make_optimizer(model), spec.to(where), pitch.to(where))
        out[where] = (float(loss), {n: p.grad.cpu() for n, p in model.named_parameters()},
                      {n: b.cpu() for n, b in model.named_buffers()})
    (lc, gc, bc), (lg, gg, bg) = out["cpu"], out[str(dev)]
    rel = abs(lg - lc) / abs(lc)
    noise = [n for n in gc if n.endswith(".b") and not n.startswith("mag_out")]
    grads = [(rel_err(gg[n], gc[n])[1], n) for n in gc if n not in noise]
    bns = [(rel_err(bg[n], bc[n])[1], n) for n in bc]
    print(f"[{label}] shallow spec, one step: loss card {lg:.8f} cpu {lc:.8f} (rel {rel:.2e}, "
          f"tol {BASELINE_LOSS_TOL:.0e}); worst of {len(grads)} gradients {max(grads)[1]} "
          f"{max(grads)[0]:.2e} (tol {BASELINE_GRAD_TOL:.0e}; the {len(noise)} pre-BN biases' "
          f"noise not held); worst BN statistic {max(bns)[1]} {max(bns)[0]:.2e} (tol "
          f"{BASELINE_BN_TOL:.0e})")
    if not (rel <= BASELINE_LOSS_TOL and max(grads)[0] <= BASELINE_GRAD_TOL
            and max(bns)[0] <= BASELINE_BN_TOL):
        raise AssertionError(f"[{label}] card and CPU disagree")


def _baseline_split(model, opt, spec, pitch) -> dict:
    """torch.profiler over one step: device time inside the forward conv ops
    (``aten::cudnn_convolution``), the forward transposed ones
    (``aten::cudnn_convolution_transpose``), both kinds' backward
    (``aten::convolution_backward``) and Adam (``Optimizer.step#Adam.step``);
    the rest of the busy time is BN, leaky relu, the loss and other
    elementwise work."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from audio_style_transfer_tpu_torch.models.baseline_ae import train_step

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(model, opt, spec, pitch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels, busy = device_busy(prof, "a baseline step")

    names = {"aten::cudnn_convolution": "conv forward",
             "aten::cudnn_convolution_transpose": "transposed conv forward",
             "aten::convolution_backward": "conv + transposed conv backward",
             "Optimizer.step#Adam.step": "Adam"}
    kinds = {v: 0.0 for v in names.values()}
    for e in prof.key_averages():
        if e.key in names:
            kinds[names[e.key]] += inclusive_us(e) / 1e3
    kinds["BN, leaky relu, loss, other"] = busy / 1e3 - sum(kinds.values())
    return dict(wall_ms=wall, launches=len(kernels), busy_ms=busy / 1e3, kinds_ms=kinds)


def baseline_train_phase(dev, smi: str, tmp: str) -> str:
    """The baseline AE at nfft_1024 (BaselineHParams(): batch 8, spectrograms
    [8, 512, 256, 1], num_latent 1984, float32, TF32 off): cli/baseline_train.py
    as a subprocess over the synthetic TFRecord, a checkpoint at its last
    step; then in this process 10 steps on one batch (ms per step by CUDA
    events, median after the warm-up; samples/s; peak memory; the loss
    falling), the step's operations and bound, one step's split under
    torch.profiler; then the card against the CPU at the shallow spec.
    Returns the CLI's logdir."""
    import torch

    from audio_style_transfer_tpu_torch.data import NSynthDataset
    from audio_style_transfer_tpu_torch.models import baseline_ae as tb

    label = "baseline train"
    path = os.path.join(tmp, "baseline.tfrecord")
    logdir = os.path.join(tmp, "baseline_log")
    out, wall = run_cli(label, "audio_style_transfer_tpu_torch.cli.baseline_train",
                        ["--train_path", path, "--logdir", logdir, "--batch_size", str(BASELINE_BATCH),
                         "--num_iters",
                         str(BASELINE_CLI_ITERS), "--log_every", "4", "--save_every",
                         str(BASELINE_CLI_ITERS), "--device", str(dev)])
    m = re.search(r"trained (\d+) steps on (\S+), last loss (\S+); last checkpoint (\S+)", out)
    if not m or int(m.group(1)) != BASELINE_CLI_ITERS or not m.group(4).endswith(
            f"ckpt-{BASELINE_CLI_ITERS}") or not math.isfinite(float(m.group(3))):
        raise AssertionError(f"[{label}] unexpected output:\n{out}")
    logged = [json.loads(line) for line in open(os.path.join(logdir, "metrics.jsonl"))]
    print(f"[{label}] cli/baseline_train.py, {BASELINE_CLI_ITERS} steps of {BASELINE_BATCH} x 64000 "
          f"samples from {BASELINE_EXAMPLES} examples in {wall:.1f} s (process start included): "
          f"losses logged {[(r['step'], round(r['loss'], 5)) for r in logged]}; "
          f"{os.path.basename(m.group(4))} ok ({smi})")

    hp = tb.BaselineHParams(batch_size=BASELINE_BATCH)
    batch = next(NSynthDataset(path, is_training=True).get_baseline_batch(hp, device=dev))
    spec = torch.from_numpy(batch["spectrogram"]).to(dev)
    pitch = torch.from_numpy(batch["pitch"]).to(dev)
    if tuple(spec.shape) != (BASELINE_BATCH, 512, 256, 1):
        raise AssertionError(f"[{label}] spectrogram batch {tuple(spec.shape)}")
    model = tb.BaselineAE(hp, seed=0).to(dev)
    opt = tb.make_optimizer(model)
    losses, ms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(BASELINE_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = tb.train_step(model, opt, spec, pitch)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"[{label}] losses {losses}: not finite or not falling")
    step_ms = float(np.median(ms[BASELINE_WARMUP:]))
    fwd, shares = baseline_flops(hp, BASELINE_BATCH)
    flops = 3.0 * fwd  # the backward: each conv's input and weight gradients, 2x forward
    bnd = bound(0.0, flops, "float32")
    tail = sum(s for _, s in shares[-3:-1])  # the last two transposed convs
    split = _baseline_split(model, opt, spec, pitch)
    busy = split["busy_ms"] / split["wall_ms"]
    print(f"[{label}] BaselineHParams() (nfft_1024), {BASELINE_BATCH} x [512, 256, 1], float32, "
          f"TF32 off: "
          f"{BASELINE_STEPS} steps on one batch, losses {[round(v, 5) for v in losses]} "
          f"(falling ok)")
    print(f"[{label}] step ms {[round(v, 2) for v in ms]} (median after {BASELINE_WARMUP} "
          f"warm-up steps {step_ms:.2f}); {BASELINE_BATCH / step_ms * 1e3:.1f} samples/s; forward "
          f"{fwd / 1e12:.3f} TFLOP ({tail:.3f} of it in the last two transposed convs), step "
          f"{flops / 1e12:.3f} TFLOP, bound {bnd['bound_ms']:.2f} ms at the float32 peak, step "
          f"/ bound {step_ms / bnd['bound_ms']:.2f}; peak memory {peak:.2f} GB ({smi})")
    kinds = ", ".join(f"{k} {v:.2f}" for k, v in split["kinds_ms"].items())
    print(f"[{label}] one step under torch.profiler: {split['wall_ms']:.2f} ms wall, "
          f"{split['launches']} device operations, device busy {split['busy_ms']:.2f} ms (busy "
          f"share {busy:.3f}); device ms by kind: {kinds} ({smi})")
    baseline_parity_phase(dev)
    return logdir


def baseline_embeddings_phase(dev, smi: str, tmp: str, logdir: str) -> None:
    """cli/baseline_save_embeddings.py from the training CLI's checkpoint over
    the same TFRecord (eval crops, 2 batches of 8): each z is [1, 1, 1984]
    and equals this process's eval-mode encode of the same batch."""
    import torch

    from audio_style_transfer_tpu_torch.data import NSynthDataset
    from audio_style_transfer_tpu_torch.models import baseline_ae as tb

    label = "baseline save_embeddings"
    path = os.path.join(tmp, "baseline.tfrecord")
    savedir = os.path.join(tmp, "baseline_z")
    out, wall = run_cli(label, "audio_style_transfer_tpu_torch.cli.baseline_save_embeddings",
                        ["--tfrecord_path", path, "--checkpoint_dir", logdir, "--savedir",
                         savedir, "--batch_size", str(BASELINE_BATCH), "--max_batches", "2",
                         "--device", str(dev)])
    if out.count(f"saved {BASELINE_BATCH} latents") != 2:
        raise AssertionError(f"[{label}] unexpected output:\n{out}")
    saved = torch.load(os.path.join(logdir, f"ckpt-{BASELINE_CLI_ITERS}"), map_location="cpu",
                       weights_only=True)
    hp = tb.BaselineHParams(batch_size=BASELINE_BATCH)
    model = tb.BaselineAE(hp)
    model.load_state_dict(saved["model"])
    model.to(dev)
    worst, n = 0.0, 0
    batches = NSynthDataset(path, is_training=False).get_baseline_batch(hp, device=dev)
    for _, batch in zip(range(2), batches):
        with torch.no_grad():
            z = model.encode(torch.from_numpy(batch["spectrogram"]).to(dev),
                             is_training=False).cpu()
        for i, key in enumerate(batch["key"]):
            got = np.load(os.path.join(savedir, f"{key.decode()}_baseline_z.npz"))
            if got["z"].shape != (1, 1, 1984) or int(got["pitch"]) != int(batch["pitch"][i]):
                raise AssertionError(f"[{label}] {key}: z {got['z'].shape}, pitch {got['pitch']}")
            worst = max(worst, rel_err(torch.from_numpy(got["z"]), z[i])[1])
            n += 1
    print(f"[{label}] {n} latents of [1, 1, 1984] from ckpt-{BASELINE_CLI_ITERS} in {wall:.1f} s "
          f"(process start included); against this process's eval encode: worst max|d| / max "
          f"{worst:.2e} (tol {BASELINE_Z_TOL:.0e}) ({smi})")
    if not worst <= BASELINE_Z_TOL:
        raise AssertionError(f"[{label}] the CLI's z differ from the encode")


def spectral_convergence(mag, audio, n_fft: int, hop: int) -> float:
    """|| |S| / ||S|| - |Y| / ||Y|| || of the target magnitude S and the
    audio's spectrum Y (scale-free: ispecgram returns peak-normalised audio)."""
    from audio_style_transfer_tpu_torch.signal.stft import centered_stft

    y = centered_stft(audio, n_fft, hop).abs()
    return float((mag / mag.norm() - y / y.norm()).norm())


def specgram_phase(dev, smi: str, tmp: str) -> None:
    """``get_baseline_batch``'s features for 8 x 64000 samples on the card
    against the port on the CPU (per-clip maxima), their ms per batch; then
    ``ispecgram(mag_only=True)`` with the reference's 1000 Griffin-Lim
    iterations (n_fft 1024, hop 256) on one clip, its ms and spectral
    convergence; the card's Griffin-Lim against the CPU's over 20 iterations
    from one start phase."""
    import torch

    from audio_style_transfer_tpu_torch.data import NSynthDataset
    from audio_style_transfer_tpu_torch.models.baseline_ae import BaselineHParams
    from audio_style_transfer_tpu_torch.signal import specgram as sg

    label = "specgram"
    hp = BaselineHParams(batch_size=BASELINE_BATCH)
    path = os.path.join(tmp, "baseline.tfrecord")
    card = next(NSynthDataset(path, is_training=False).get_baseline_batch(hp, device=dev))
    host = next(NSynthDataset(path, is_training=False).get_baseline_batch(hp, device="cpu"))
    diff = np.abs(card["spectrogram"] - host["spectrogram"])
    loud = host["spectrogram"] >= 0.5
    d, d_floor = float(diff[loud].max()), float(diff[~loud].max(initial=0.0))
    audio = torch.from_numpy(card["audio"]).to(dev)
    feat_ms = cuda_ms(lambda: sg.specgram(audio, n_fft=hp.n_fft, hop_length=hp.hop_length,
                                          mag_only=True))
    print(f"[{label}] get_baseline_batch, {BASELINE_BATCH} x 64000 samples -> {card['spectrogram'].shape}: "
          f"card vs CPU max|d| {d:.2e} within 60 dB of each clip's peak (tol {SPEC_TOL:.0e}; "
          f"{loud.mean():.3f} of the bins), {d_floor:.2e} below (tol {SPEC_FLOOR_TOL:.0e}); "
          f"specgram on the card {feat_ms:.3f} ms per batch ({smi})")
    if not (d <= SPEC_TOL and d_floor <= SPEC_FLOOR_TOL):
        raise AssertionError(f"[{label}] features: card and CPU disagree")

    clip = audio[0]
    spec = sg.specgram(clip, n_fft=1024, hop_length=256, mag_only=True)  # [513, 251, 1]
    mag = 10.0 ** ((spec[..., 0] - 1.0) * 120.0 / 20.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wav = sg.ispecgram(spec, n_fft=1024, hop_length=256, num_iters=GL_ITERS)
    torch.cuda.synchronize()
    gl_ms = (time.perf_counter() - t0) * 1e3
    conv = spectral_convergence(mag, wav, 1024, 256)
    start = math.pi * torch.rand(mag.shape, generator=torch.Generator().manual_seed(0))
    conv0 = spectral_convergence(mag, sg.griffin_lim(mag, start.to(dev), 1024, 256, 1), 1024, 256)
    got = sg.griffin_lim(mag, start.to(dev), 1024, 256, GL_CHECK_ITERS).cpu()
    want = sg.griffin_lim(mag.cpu(), start, 1024, 256, GL_CHECK_ITERS)
    err = rel_err(got, want)[1]
    print(f"[{label}] ispecgram(mag_only=True), {GL_ITERS} Griffin-Lim iterations, n_fft 1024, "
          f"hop 256, one clip of 64000 samples: {gl_ms:.1f} ms ({gl_ms / GL_ITERS:.3f} ms per "
          f"iteration, host clock); spectral convergence {conv:.4f} (from {conv0:.4f} at the "
          f"start phase); {GL_CHECK_ITERS} iterations card vs CPU from one phase: max|d| / max "
          f"{err:.2e} (tol {GL_TOL:.0e}) ({smi})")
    if not (err <= GL_TOL and conv < conv0 and wav.shape == (64000,)
            and bool(torch.isfinite(wav).all())):
        raise AssertionError(f"[{label}] Griffin-Lim failed its checks")


def cqt_phase(dev, smi: str) -> None:
    """The card's CQT of a 4 s clip against the host multirate oracle (the
    bound of tests/test_cqt_fidelity.py: 3% of an interior frame's peak at
    most, 0.3% on average) and against the port's CPU CQT; its ms."""
    import torch

    from audio_style_transfer_tpu_torch.signal.cqt import cqt
    from audio_style_transfer_tpu_torch.signal.cqt_multirate import multirate_cqt

    label = "cqt"
    x = synth_audio(CQT_SECONDS, kind="style")
    xd = torch.from_numpy(x).to(dev)
    got = cqt(xd)
    host = cqt(torch.from_numpy(x))
    err = rel_err(torch.view_as_real(got.cpu()), torch.view_as_real(host))[1]
    t0 = time.perf_counter()
    oracle = multirate_cqt(x)
    host_s = time.perf_counter() - t0
    m_dev = got.abs().cpu().numpy()[:, 8:-8]
    m_orc = np.abs(oracle)[:, 8:-8]
    dev_frac = np.abs(m_dev - m_orc) / np.maximum(m_orc.max(axis=0, keepdims=True), 1e-12)
    ms = cuda_ms(lambda: cqt(xd))
    print(f"[{label}] {CQT_SECONDS:.0f} s clip, 240 bins x {got.shape[-1]} frames: card vs CPU "
          f"max|d| / max {err:.2e} (tol {CQT_TOL:.0e}); against the multirate oracle per frame "
          f"peak max {dev_frac.max():.4f} mean {dev_frac.mean():.5f} (bound 0.03 / 0.003); card "
          f"{ms:.3f} ms, the host oracle {host_s:.2f} s ({smi})")
    if not (err <= CQT_TOL and dev_frac.max() < 0.03 and dev_frac.mean() < 0.003):
        raise AssertionError(f"[{label}] the card's CQT failed its checks")


def output_grams_phase(dev, smi: str) -> dict:
    """cli/output_grams.py's per-window function (``window_grams``; ``main``
    draws figures and needs matplotlib) at length 16384, the full stack (L =
    30), float32, over a 3-window synthetic clip: exactly K1 30 and K5 1 per
    window; each window's grams against the plain trunk (ops.conv) and the
    plain gram (einsum) on the card."""
    import argparse

    import torch

    from audio_style_transfer_tpu_torch.cli import output_grams
    from audio_style_transfer_tpu_torch.ops import _build
    from audio_style_transfer_tpu_torch.ops.chain import reference_trunk, stack_trunk_weights
    from audio_style_transfer_tpu_torch.ops.conv import conv1d
    from audio_style_transfer_tpu_torch.ops.gram import pair_gram_reference
    from audio_style_transfer_tpu_torch.signal.mu_law import mu_law_numpy
    from audio_style_transfer_tpu_torch.transfer.grams import l2_normalize

    label = "output grams"
    args = argparse.Namespace(random_init=True, stack=None, length=T, channels=C,
                              device=str(dev), ckpt_path="")
    engine = output_grams.make_engine(args)
    audio = synth_audio(GRAMS_WINDOWS * T / 16000 + 0.01, kind="style")
    windows = [audio[i * T : (i + 1) * T] for i in range(GRAMS_WINDOWS)]
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    grams = output_grams.window_grams(engine, windows)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    want = {k: 0 for k in KERNELS}
    want.update(K1=LAYERS * GRAMS_WINDOWS, K5=GRAMS_WINDOWS)
    if launches != want:
        raise AssertionError(f"[{label}] launched {launches}, want K1 {LAYERS} and K5 1 a "
                             "window and nothing else")
    p = engine.params
    wd, bd, wr, br = stack_trunk_weights(p, LAYERS)
    dils = tuple(engine.cfg.ae_dilation(k) for k in range(LAYERS))
    worst = 0.0
    with torch.no_grad():
        for aud, got in zip(windows, grams):
            xq = torch.tensor(mu_law_numpy(aud[None]), dtype=torch.float32, device=dev)
            enc = conv1d((xq / 128.0)[..., None], p["ae_startconv"]["w"], p["ae_startconv"]["b"],
                         causal=False)
            taps = reference_trunk(enc[0], wd, bd, wr, br, dils, tuple(range(LAYERS)))
            g = pair_gram_reference(*[t[None] for t in taps])
            ref = l2_normalize(g[0].permute(2, 0, 1), axes=(1, 2))
            worst = max(worst, rel_err(torch.from_numpy(got), ref.cpu())[1])
    # Steady state, after the counted run: one window a call (its launches
    # are not the main path's and are not returned).
    steady = cuda_ms(lambda: output_grams.window_grams(engine, windows[:1]), reps=5, warmup=1)
    print(f"[{label}] window_grams, {GRAMS_WINDOWS} windows of {T} samples, full stack (L=30), "
          f"float32: grams {grams[0].shape} each; launches {launches}: K1 {LAYERS} and K5 1 a "
          f"window, the rest 0 ok; against the plain trunk and gram on the card worst max|d| / "
          f"max {worst:.2e} (tol {GRAMS_TOL:.0e}); {wall * 1e3:.1f} ms for the {GRAMS_WINDOWS} "
          f"windows (host clock, set-up included), {steady:.2f} ms a window steady (CUDA "
          f"events, the copy to the host included) ({smi})")
    if not worst <= GRAMS_TOL:
        raise AssertionError(f"[{label}] grams disagree with the plain trunk and gram")
    return launches


def sidecar_phases(dev, smi: str) -> dict:
    """Every M9 phase over one synthetic TFRecord; the kernel launches of the
    output-grams path."""
    with tempfile.TemporaryDirectory() as tmp:
        write_baseline_records(os.path.join(tmp, "baseline.tfrecord"))
        logdir = baseline_train_phase(dev, smi, tmp)
        baseline_embeddings_phase(dev, smi, tmp, logdir)
        specgram_phase(dev, smi, tmp)
    cqt_phase(dev, smi)
    return output_grams_phase(dev, smi)


# ---------------------------------------------------------------------- #
# The last modules (M9b): the SciPy parity harness and the NSynth examples.
# ---------------------------------------------------------------------- #

SCIPY_SEEDS = 2  # the JAX module's defaults and its slow test's full-size run
SCIPY_MAXITER = 100
EXAMPLE_SAMPLES = 8192  # --sample_length of both example runs
EXAMPLE_STRETCH = 1.5  # interpolation's default --stretch


def _leg_timer(legs: list, leg: str, fn):
    """``fn`` wrapped so that each call appends (leg, seconds to the device's
    end, the kernel launches it made) to ``legs``."""
    import torch

    from audio_style_transfer_tpu_torch.ops import _build

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        before = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        legs.append((leg, time.perf_counter() - t0,
                     {k: _build.LAUNCHES[k] - before[k] for k in KERNELS}))
        return out

    return timed


def scipy_parity_phase(dev, smi: str) -> dict:
    """``transfer/scipy_parity.py::run_parity`` at full geometry (30 layers of
    128, T=16384, stack 0: style taps 0..9, content tap 29; float32, TF32
    off), maxiter 100, 2 seeds, the MT line search: each seed's record, each
    leg's wall and ms per evaluation, and its launches. Every gradient
    evaluation of either leg is K1 30, K2 30, K5 1, K6 1; the two targets
    and the start loss a seed are forward passes (K1 30, K5 1). Each seed
    must pass ``main``'s rule."""
    from unittest import mock

    import scipy.optimize
    import torch

    from audio_style_transfer_tpu_torch.ops import _build
    from audio_style_transfer_tpu_torch.transfer import lbfgs, scipy_parity

    label = "scipy parity"
    legs = []
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    with mock.patch.object(lbfgs, "lbfgs_minimize",
                           _leg_timer(legs, "ours", lbfgs.lbfgs_minimize)), \
            mock.patch.object(scipy.optimize, "minimize",
                              _leg_timer(legs, "scipy", scipy.optimize.minimize)):
        records = scipy_parity.run_parity(t=T, maxiter=SCIPY_MAXITER, seeds=SCIPY_SEEDS,
                                          stack0=True, line_search="mt", device=str(dev))
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    if len(records) != SCIPY_SEEDS or [leg for leg, *_ in legs] != ["ours", "scipy"] * SCIPY_SEEDS:
        raise AssertionError(f"[{label}] {len(records)} records, legs {[g for g, *_ in legs]}")
    for i, r in enumerate(records):
        print(f"[{label}] {json.dumps(r)}")
        for leg, secs, got in legs[2 * i : 2 * i + 2]:
            evals = r[f"{leg}_evals"]
            want = {k: 0 for k in KERNELS}
            want.update(K1=LAYERS * evals, K2=LAYERS * evals, K5=evals, K6=evals)
            print(f"[{label}] seed {r['seed']} {leg}: {evals} evaluations in {secs:.3f} s, "
                  f"{secs / evals * 1e3:.3f} ms per evaluation (host clock, to the device's "
                  f"end); launches {got} ({smi})")
            if got != want:
                raise AssertionError(f"[{label}] seed {r['seed']} {leg}: launched {got}, want "
                                     f"{want}: K1/K2 {LAYERS} and K5/K6 1 per evaluation")
    evals = sum(r["ours_evals"] + r["scipy_evals"] for r in records)
    passes = evals + 3 * SCIPY_SEEDS  # + the two targets and the start loss a seed
    want = {k: 0 for k in KERNELS}
    want.update(K1=LAYERS * passes, K2=LAYERS * evals, K5=passes, K6=evals)
    if launches != want:
        raise AssertionError(f"[{label}] launched {launches}, want {want}")
    print(f"[{label}] launches {launches}: K2 {LAYERS} and K6 1 per gradient evaluation "
          f"({evals}), K1 {LAYERS} and K5 1 per pass ({passes}, the targets and start losses "
          f"included), the rest 0 ok; {SCIPY_SEEDS} seeds in {wall:.1f} s ({smi})")
    failed = [r["seed"] for r in records if not scipy_parity.passes(r)]
    if failed:
        raise AssertionError(f"[{label}] seeds {failed} fail main()'s rule: |rel| <= 1%, or "
                             "SciPy stalled and ours <= 1.01 x SciPy's")
    rels = ", ".join(f"{r['rel']:.2e}" for r in records)
    print(f"[{label}] every seed passes main()'s rule (|rel| <= 1%, or SciPy stalled and ours "
          f"<= 1.01 x SciPy's): rel {rels}, stalled {[r['scipy_stalled'] for r in records]} ok")
    return launches


def examples_phase(dev, smi: str) -> dict:
    """examples/how_to_use_torch.py and examples/interpolation_torch.py, each
    ``main(argv)`` in this process with ``--random_init --device <card>
    --sample_length 8192`` on synthetic wavs, from a temporary working
    directory (the scripts write there): every wav they write is finite and
    frames x 512 samples long (the stretched one round(frames x 1.5) x 512),
    and ``encode`` launched K1 30 times a call and nothing else."""
    import torch

    from audio_style_transfer_tpu_torch.ops import _build
    from audio_style_transfer_tpu_torch.utils.audio_io import read_wav
    from examples import how_to_use_torch, interpolation_torch

    label = "examples"
    frames = EXAMPLE_SAMPLES // 512
    common = ["--random_init", "--device", str(dev), "--sample_length", str(EXAMPLE_SAMPLES)]
    runs = (  # script, argv, encode calls, {wav written: frames}
        ("how_to_use_torch.py", how_to_use_torch.main, ["content.wav", *common], 1,
         {"gen_content.wav": frames}),
        ("interpolation_torch.py", interpolation_torch.main, ["content.wav", "style.wav", *common],
         2, {"interp.wav": frames, "stretched.wav": round(frames * EXAMPLE_STRETCH)}),
    )
    total = {k: 0 for k in KERNELS}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        for name, kind in (("content", "content"), ("style", "style")):
            write_wav(os.path.join(tmp, f"{name}.wav"), synth_audio(1.0, kind=kind))
        os.chdir(tmp)
        try:
            for script, main, argv, calls, wavs in runs:
                torch.cuda.synchronize()
                _build.reset_launches()
                t0 = time.perf_counter()
                out = io.StringIO()
                with contextlib.redirect_stdout(out):
                    main(argv)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = dict(_build.LAUNCHES)
                want = {k: 0 for k in KERNELS}
                want["K1"] = LAYERS * calls
                if launches != want:
                    raise AssertionError(f"[{label}] {script} launched {launches}, want K1 "
                                         f"{LAYERS} a call of encode ({calls}) and nothing else")
                lengths = {}
                for wav, n in wavs.items():
                    audio, sr = read_wav(os.path.join(tmp, wav))
                    lengths[wav] = audio.shape[-1]
                    if audio.shape != (1, n * 512) or sr != 16000 \
                            or not np.all(np.isfinite(audio)):
                        raise AssertionError(f"[{label}] {script}: {wav} {audio.shape} at {sr}, "
                                             f"want (1, {n * 512})")
                for k, v in launches.items():
                    total[k] += v
                print(f"[{label}] {script} {' '.join(argv)}: {wall:.1f} s (weights, encode and "
                      f"synthesize, host clock); wrote {lengths} samples, finite ok; launches "
                      f"{launches}: K1 {LAYERS} a call of encode, the rest 0 ok ({smi})")
                print("\n".join(f"[{label}]   {line}" for line in out.getvalue().splitlines()))
        finally:
            os.chdir(cwd)
    return total


def composed_parity_note() -> None:
    """The composed parity is not run here: its reference leg is a
    TensorFlow graph, which the card's machine does not install."""
    import importlib.util

    print("[composed parity] not run on the card: its oracle is a TensorFlow graph "
          "(transfer/composed_parity.py), and TensorFlow is importable here: "
          f"{importlib.util.find_spec('tensorflow') is not None}; "
          "tests/test_torch_composed_parity.py holds it on the CPU")


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
        results[dtype_name].update(decoder_kernel_phase(dtype_name, dev))
        results[dtype_name].update(layer_gram_kernel_phase(dtype_name, dev))
        if dtype_name == "bfloat16":
            results[dtype_name].update(taps_pack_phase(dev))
            results[dtype_name]["pair gram clip"] = pair_gram_clip_phase(dev)
            results[dtype_name]["trunk phases"] = trunk_phase_times(params, dev)
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
        "cli gatys": (["--gatys", "--stack", "0"], {"K1", "K2", "K8f", "K8b"}, None),
    }
    runs = {}
    for label, (path_args, expected, band) in cli_paths.items():
        runs[label] = cli_phase(dev, label, path_args, expected)
        runs[f"{label}, float32"] = cli_phase(dev, f"{label}, float32", path_args, expected,
                                              precision="float32", band=band)
    runs.update(tf1_checkpoint_phase(dev, smi, runs))
    runs.update({
        "per-layer engine": per_layer_phase(params, dev),
        "per-layer exact scan": per_layer_window_phase(params, dev),
        "exact scan, wavefront on": exact_wavefront_phase(params, dev),
        "longform, wavefront on": longform_phase(dev, wavefront=True, epochs=2),
        "longform, wavefront off": longform_phase(dev, wavefront=False, epochs=1),
        "exact, one window": exact_phase(dev, "exact, one window", None),
        "exact, scan": exact_phase(dev, "exact, scan", SCAN_WINDOW),
    })
    gen_launches, enc16 = generate_encode_phase(params, dev)
    generate_decoder_phase(params, dev, enc16)
    synth_rows = generate_synth_phase(params, dev, enc16, smi)
    generate_device_ops(params, dev, synth_rows[0]["steady_us"])
    generate_cli_phase(params, dev)
    train_launches, train_trunk = train_phases(dev, smi)
    dp_launches, exact_sharded_runs = nccl_world1_phases(dev, smi)
    runs.update(exact_sharded_runs)
    gloo_runs, gloo_train_launches = gloo_phases(dev, smi)
    runs.update(gloo_runs)
    grams_launches = sidecar_phases(dev, smi)
    parity_launches = scipy_parity_phase(dev, smi)
    example_launches = examples_phase(dev, smi)
    composed_parity_note()
    for part in (dp_launches, gloo_train_launches, grams_launches, parity_launches,
                 example_launches):
        for k, v in part.items():
            train_launches[k] += v
    for label, (_, evals, wall, *_) in runs.items():
        print(f"[{label}] {evals} evals, {evals / wall:.2f} evals/s setup included ({smi})")
    # bf16 against f32 from the same 1e-6 start. Printed, not yet a check: the
    # bf16 zoom search from that start lands in one of two basins by rounding
    # (ROADMAP.md, faults, item 1), in the JAX package as in the port.
    for label in cli_paths:
        b16, f32 = runs[label][3], runs[f"{label}, float32"][3]
        print(f"[{label}] final loss bf16 {b16:.4f} / f32 {f32:.4f} = {b16 / f32:.4f}")
    launches = {k: sum(r[0][k] for r in runs.values()) + gen_launches[k] + train_launches[k]
                for k in KERNELS}

    src = "audio_style_transfer_tpu_torch/csrc/"
    meta = {  # kernel: (name, source, replaces, the timing key)
        "K1": ("trunk forward layer", src + "trunk_mma.cu",
               "audio_style_transfer_tpu/ops/pallas_chain.py:521", "K1"),
        "K2": ("trunk backward layer", src + "trunk_mma.cu",
               "audio_style_transfer_tpu/ops/pallas_chain.py:672", "K2"),
        "K2wf": ("trunk backward wavefront group of 4 layers", src + "trunk_wf_mma.cu",
                 "audio_style_transfer_tpu/ops/pallas_chain.py:851", "K2wf"),
        "K5": ("pair gram forward, L=30", src + "gram.cu",
               "audio_style_transfer_tpu/ops/pallas_gram.py:72", "K5 L=30"),
        "K6": ("pair gram backward, L=30", src + "gram.cu",
               "audio_style_transfer_tpu/ops/pallas_gram.py:109", "K6 L=30"),
        "K7f": ("encoder block forward", src + "trunk_mma.cu",
                "audio_style_transfer_tpu/ops/pallas_encoder.py:203", "K7f"),
        "K7b": ("encoder block backward", src + "trunk_mma.cu",
                "audio_style_transfer_tpu/ops/pallas_encoder.py:288", "K7b"),
    }
    for k, name in (("gate_fwd", "decoder gate forward"), ("gate_bwd", "decoder gate backward"),
                    ("residual_fwd", "decoder residual and skip forward"),
                    ("residual_bwd", "decoder residual and skip backward")):
        meta[k] = (f"{name}, 32 x 6144", src + "decoder.cu",
                   "none (XLA fuses these ops in the JAX package)", k)
    for k, name in (("K8f", "per-layer gram forward"), ("K8b", "per-layer gram backward")):
        meta[k] = (f"{name}, {LAYER_GRAM_ROWS} rows, L=30", src + "gram.cu",
                   "none (XLA's einsum in the JAX package, transfer/grams.py:72-79)", k)
    kernels = []
    for k, (name, source, replaces, key) in meta.items():
        r = results["bfloat16"][key]
        kernels.append({"name": f"{k} {name} (bf16)", "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[k],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
        if "k2_launches_ms" in r:  # K2-wf: the K2 launches it replaces
            kernels[-1]["k2_launches_ms"] = r["k2_launches_ms"]
        if "windowed_ms" in r:  # the same kernel with a valid window
            kernels[-1].update(windowed_ms=r["windowed_ms"],
                               windowed_max_abs_err=r["windowed_max_abs_err"])
        if k in exact_shapes["bfloat16"]:  # all but the grams at L=30 (L=10 there)
            kernels[-1]["exact_shapes_max_abs_err"] = exact_shapes["bfloat16"][k]
        if k in ("K5", "K6"):  # at the 15 s clip's rows, by taps
            clip = results["bfloat16"]["pair gram clip"]
            for dtype_name, key in (("bfloat16", "clip_ms_by_taps"),
                                    ("float32", "clip_f32_ms_by_taps")):
                kernels[-1][key] = {nl: clip[f"{k} {dtype_name} {PAIR_GRAM_ROWS} L={nl}"]
                                    for nl in (LAYERS, len(STYLE))}
        if k in ("K1", "K2"):  # layer by layer at the training step's 32 x 6144 rows
            kernels[-1].update(train_shape_max_abs_err=train_trunk["bfloat16"][k.lower()],
                               train_shape_f32_max_abs_err=train_trunk["float32"][k.lower()])
            kernels[-1]["profiler_ms_by_rows"] = {  # per launch, by phase for K2
                rows: ({"ms": p["k1_ms"], "bound_ms": p["k1_bound_ms"]} if k == "K1" else
                       {"dy_ms": p["k2_dy_ms"], "dx_ms": p["k2_dx_ms"],
                        "bound_ms": p["k2_bound_ms"]})
                for rows, p in results["bfloat16"]["trunk phases"].items()}
    for name in TAPS_PACK_CASES:  # one kernel: the main paths' launches, shared by its cases
        r = results["bfloat16"][f"TP {name}"]
        kernels.append({"name": f"TP merged-taps pack, {name}, 32 x 6144 (bf16)", "route": "cuda",
                        "source": src + "conv.cu",
                        "replaces": "none (XLA's conv reads the taps in place in the JAX package)",
                        "launches": launches["taps_pack"], "launches_of": "every case",
                        "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": None})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
