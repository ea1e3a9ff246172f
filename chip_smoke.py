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
     K7f/K7b layer by layer on the plain chain's own inputs, K5 and K6 on
     the stack-0 taps {0..9} (L=10) and on all 30 taps (L=30);
  4. one float32 loss + waveform gradient on the card against the plain
     versions on the CPU, for stack 0 and for the full stack (style taps
     0..29, content tap 25);
  5. drive the main paths, each with the launch counts set to 0 just before
     and read just after, checking that it launched exactly its kernels:
     the port's transfer CLI on two synthetic clips (bf16, random weights,
     3 epochs) at stack 0 {K1, K2, K5} and at the full stack with
     --cont_lyrs 25 {K1, K2, K5, K6}, then one bf16 engine epoch of the
     per-layer flavour at the full stack {K7f, K7b, K5, K6};
  6. print the per-kernel JSON line, then the result line.

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
KERNELS = ("K1", "K2", "K5", "K6", "K7f", "K7b")


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


def cuda_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
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


def kernel_phase(dtype_name: str, params, dev) -> dict:
    """Compare K1, K2, K5, K6, K7f and K7b with their plain versions; time
    both."""
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
        kmasks.append(m_k)
    print(f"  K1 taps: max|d| {k1_err:.3e} over 30 layers (tol rel {tol:.0e}) ok; "
          f"mask bytes differing <= {mask_share:.2e} (tol {MASK_TOL:.0e}) ok")
    print(f"  K7f out: max|d| {k7f_err:.3e} over 30 layers (tol rel {tol:.0e}) ok")

    # K2 and K7b, layer by layer on the plain chain's cotangents (and masks).
    dtaps = {j: (torch.randn((T, C), generator=gen, device=dev) * 1e-3).to(dt) for j in EMIT}
    dx = dtaps[LAYERS - 1]
    k2_err, k7b_err = 0.0, 0.0
    gs = {}
    for j in range(LAYERS - 1, -1, -1):
        dtap = dtaps.get(j) if j != LAYERS - 1 else None
        in_m = masks[j - 1] if j > 0 else inmask
        dx_p = chain.layer_bwd_plain(dx, dtap, masks[j], in_m, wd[j], wr[j], dils[j], T)
        dx_k = chain.layer_bwd(dx, dtap, masks[j], in_m, wd[j], wr[j], dils[j], T)
        abs_err, rel = rel_err(dx_k, dx_p)
        if rel > tol:
            raise AssertionError(f"K2 layer {j}: rel err {rel:.3e} > {tol}")
        k2_err = max(k2_err, abs_err)
        gs[j] = dx if dtap is None else dx + dtap  # layer j's output cotangent
        # K7b recomputes its gate y > 0 from x with K1's dilated-conv code,
        # so its gate is bit 1 of K1's mask, whose flips against the plain
        # gate are bounded above. Its plain version here takes that gate: a
        # y within rounding of zero that flips would move the cotangent of
        # its neighbourhood by about its own size.
        want = chain.layer_bwd_plain(gs[j], None, kmasks[j], (xs[j] > 0).to(torch.uint8),
                                     wd[j], wr[j], dils[j], T)
        abs_err, rel = rel_err(encoder.block_bwd(xs[j], gs[j], wd[j], bd[j], wr[j], dils[j], T),
                               want)
        if rel > tol:
            raise AssertionError(f"K7b layer {j}: rel err {rel:.3e} > {tol}")
        k7b_err = max(k7b_err, abs_err)
        dx = dx_p
    print(f"  K2 dx: max|d| {k2_err:.3e} over 30 layers (tol rel {tol:.0e}) ok")
    print(f"  K7b dx: max|d| {k7b_err:.3e} over 30 layers (tol rel {tol:.0e}; plain version "
          f"with K1's gate) ok")

    # K5 and K6 on the ten stack-0 taps and on all 30 taps.
    taps = {nl: [xs[j + 1][None] for j in range(nl)] for nl in (10, 30)}
    hs = {nl: torch.randn((1, nl, nl, C), generator=gen, device=dev) for nl in (10, 30)}
    errs = {}
    for nl in (10, 30):
        errs[f"K5 L={nl}"] = check(f"K5 gram L={nl}", gram.pair_gram_fwd(*taps[nl]),
                                   gram.pair_gram_reference(*taps[nl]), tol)
        errs[f"K6 L={nl}"] = check_all(f"K6 gram backward L={nl}",
                                       gram.pair_gram_bwd(taps[nl], hs[nl]),
                                       gram.pair_gram_bwd_plain(taps[nl], hs[nl]), tol)

    # Times: a whole trunk direction (30 launches) and one gram.
    def fwd(layer):
        def run():
            cur = x0
            for j, d in enumerate(dils):
                cur = layer(cur, wd[j], bd[j], wr[j], br[j], d, T, j == 0)[0]
        return run

    def bwd(layer):
        def run():
            cur = dtaps[LAYERS - 1]
            for j in range(LAYERS - 1, -1, -1):
                in_m = masks[j - 1] if j > 0 else inmask
                dtap = dtaps.get(j) if j != LAYERS - 1 else None
                cur = layer(cur, dtap, masks[j], in_m, wd[j], wr[j], dils[j], T)
        return run

    def blocks(block, backward: bool):
        def run():
            for j, d in enumerate(dils):
                if backward:
                    block(xs[j], gs[j], wd[j], bd[j], wr[j], d, T)
                else:
                    block(xs[j], wd[j], bd[j], wr[j], br[j], d, T)
        return run

    times = {
        "K1": (cuda_ms(fwd(chain.layer_fwd)) / LAYERS,
               cuda_ms(fwd(chain.layer_fwd_plain)) / LAYERS),
        "K2": (cuda_ms(bwd(chain.layer_bwd)) / LAYERS,
               cuda_ms(bwd(chain.layer_bwd_plain)) / LAYERS),
        "K7f": (cuda_ms(blocks(encoder.block_fwd, False)) / LAYERS,
                cuda_ms(blocks(encoder.block_fwd_plain, False)) / LAYERS),
        "K7b": (cuda_ms(blocks(encoder.block_bwd, True)) / LAYERS,
                cuda_ms(blocks(encoder.block_bwd_plain, True)) / LAYERS),
    }
    for nl in (10, 30):
        times[f"K5 L={nl}"] = (cuda_ms(lambda: gram.pair_gram_fwd(*taps[nl])),
                               cuda_ms(lambda: gram.pair_gram_reference(*taps[nl])))
        times[f"K6 L={nl}"] = (cuda_ms(lambda: gram.pair_gram_bwd(taps[nl], hs[nl])),
                               cuda_ms(lambda: gram.pair_gram_bwd_plain(taps[nl], hs[nl])))
    for k, (ms, plain_ms) in times.items():
        print(f"  {k} time per launch: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    errs.update({"K1": k1_err, "K2": k2_err, "K7f": k7f_err, "K7b": k7b_err})
    return {k: dict(max_abs_err=errs[k], ms=times[k][0], plain_ms=times[k][1]) for k in errs}


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


def check_launches(label: str, launches: dict, expected: set) -> None:
    """The path launched every kernel of ``expected`` and no other."""
    missing = [k for k in sorted(expected) if launches[k] == 0]
    extra = [k for k in KERNELS if k not in expected and launches[k] != 0]
    if missing or extra:
        raise AssertionError(f"{label}: kernels not launched {missing}, launched but not on "
                             f"this path {extra}: {launches}")
    print(f"[{label}] launches {launches}: {sorted(expected)} all > 0, the rest 0 ok")


def check_losses(label: str, losses, audio_or_x) -> None:
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{label}: non-finite losses {losses}")
    if any(b > a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"{label}: losses increase across epochs: {losses}")
    if audio_or_x.shape != (T,) or not np.all(np.isfinite(audio_or_x)):
        raise AssertionError(f"{label}: the output waveform is not finite [{T}]")


def cli_phase(dev, label: str, path_args: list, expected: set):
    """The port's CLI, 3 epochs of bf16 transfer; returns (launches, evals,
    wall seconds)."""
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
                "--precision", "bfloat16", "--fused", "--random_init", "--no_artifacts",
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
    check_losses(label, losses, audio)
    check_launches(label, launches, expected)
    print(f"[{label}] {len(rows)} epochs, losses {losses}, {evals} L-BFGS evals in "
          f"{wall:.2f} s wall ({evals / wall:.2f} evals/s, setup included)")
    return launches, evals, wall


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
    check_launches(label, launches, {"K7f", "K7b", "K5", "K6"})
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
    results = {}
    for dtype_name in ("float32", "bfloat16"):
        results[dtype_name] = kernel_phase(dtype_name, params, dev)
    slice_phase(params, dev, STYLE, (29,))
    slice_phase(params, dev, FULL, (25,))
    runs = {
        "cli stack 0": cli_phase(dev, "cli stack 0", ["--stack", "0"], {"K1", "K2", "K5"}),
        "cli full stack": cli_phase(dev, "cli full stack", ["--cont_lyrs", "25"],
                                    {"K1", "K2", "K5", "K6"}),
        "per-layer engine": per_layer_phase(params, dev),
    }
    for label, (_, evals, wall) in runs.items():
        print(f"[{label}] {evals} evals, {evals / wall:.2f} evals/s setup included ({smi})")
    launches = {k: sum(r[0][k] for r in runs.values()) for k in KERNELS}

    src = "audio_style_transfer_tpu_torch/csrc/"
    meta = {  # kernel: (name, source, replaces, the timing key)
        "K1": ("trunk forward layer", src + "trunk.cu",
               "audio_style_transfer_tpu/ops/pallas_chain.py:521", "K1"),
        "K2": ("trunk backward layer", src + "trunk.cu",
               "audio_style_transfer_tpu/ops/pallas_chain.py:672", "K2"),
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
                        "plain_ms": r["plain_ms"]})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
