"""Drive the PyTorch/CUDA port once on one GPU and check it.

Run from the root of the repository:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the hand-written kernels (audio_style_transfer_tpu_torch/csrc);
  3. hold each kernel against its plain PyTorch version at the stack-0
     shapes (T=16384, C=128, the 30 trunk layers, taps {0..9, 29}, L=10),
     in float32 with TF32 off and in bfloat16, and time both (CUDA events,
     median of runs); then one float32 loss + waveform gradient at full
     geometry on the card against the plain versions on the CPU;
  4. run the port's transfer CLI on two synthetic clips (stack 0, bf16,
     random weights, 3 epochs) and check the losses and that every kernel of
     the path was launched during that run;
  5. print the per-kernel JSON line, then the result line.

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

import numpy as np

T, C, LAYERS = 16384, 128, 30
STYLE = tuple(range(10))
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


def kernel_phase(dtype_name: str, params, dev) -> dict:
    """Compare K1, K2 and K5 with their plain versions; time both."""
    import torch

    from audio_style_transfer_tpu_torch.ops import chain, gram

    dt = getattr(torch, dtype_name)
    tol = TOL[dtype_name]
    dils = tuple(2 ** (k % 10) for k in range(LAYERS))
    wd, bd, wr, br = chain.stack_trunk_weights(params, LAYERS)
    wd, wr = wd.to(dev, dt).contiguous(), wr.to(dev, dt).contiguous()
    bd, br = bd.to(dev, torch.float32).contiguous(), br.to(dev, torch.float32).contiguous()
    gen = torch.Generator(device=dev).manual_seed(0)
    x0 = (torch.randn((T, C), generator=gen, device=dev) * 0.5).to(dt)
    print(f"[kernels {dtype_name}] T={T} C={C} layers={LAYERS} emit={EMIT}")

    # K1, layer by layer on the plain chain's own inputs.
    xs, masks, inmask = [x0], [], None
    k1_err, mask_share = 0.0, 0.0
    for j, d in enumerate(dils):
        out_p, m_p, im_p = chain.layer_fwd_plain(xs[-1], wd[j], bd[j], wr[j], br[j], d, T,
                                                 want_inmask=(j == 0))
        out_k, m_k, im_k = chain.layer_fwd(xs[-1], wd[j], bd[j], wr[j], br[j], d, T,
                                           want_inmask=(j == 0))
        abs_err, rel = rel_err(out_k, out_p)
        if rel > tol:
            raise AssertionError(f"K1 layer {j}: rel err {rel:.3e} > {tol}")
        k1_err = max(k1_err, abs_err)
        share = float((m_k != m_p).float().mean())
        if j == 0:
            share = max(share, float((im_k != im_p).float().mean()))
            inmask = im_p
        mask_share = max(mask_share, share)
        if share > MASK_TOL:
            raise AssertionError(f"K1 layer {j}: {share:.2e} of mask bytes differ")
        xs.append(out_p)
        masks.append(m_p)
    print(f"  K1 taps: max|d| {k1_err:.3e} over 30 layers (tol rel {tol:.0e}) ok; "
          f"mask bytes differing <= {mask_share:.2e} (tol {MASK_TOL:.0e}) ok")

    # K2, layer by layer on the plain chain's cotangents and masks.
    dtaps = {j: (torch.randn((T, C), generator=gen, device=dev) * 1e-3).to(dt) for j in EMIT}
    dx = dtaps[LAYERS - 1]
    k2_err = 0.0
    for j in range(LAYERS - 1, -1, -1):
        dtap = dtaps.get(j) if j != LAYERS - 1 else None
        in_m = masks[j - 1] if j > 0 else inmask
        dx_p = chain.layer_bwd_plain(dx, dtap, masks[j], in_m, wd[j], wr[j], dils[j], T)
        dx_k = chain.layer_bwd(dx, dtap, masks[j], in_m, wd[j], wr[j], dils[j], T)
        abs_err, rel = rel_err(dx_k, dx_p)
        if rel > tol:
            raise AssertionError(f"K2 layer {j}: rel err {rel:.3e} > {tol}")
        k2_err = max(k2_err, abs_err)
        dx = dx_p
    print(f"  K2 dx: max|d| {k2_err:.3e} over 30 layers (tol rel {tol:.0e}) ok")

    # K5 on the ten stack-0 taps.
    taps = [xs[j + 1][None] for j in STYLE]
    k5_err = check("K5 gram", gram.pair_gram_fwd(*taps), gram.pair_gram_reference(*taps), tol)

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

    times = {
        "K1": (cuda_ms(fwd(chain.layer_fwd)) / LAYERS,
               cuda_ms(fwd(chain.layer_fwd_plain)) / LAYERS),
        "K2": (cuda_ms(bwd(chain.layer_bwd)) / LAYERS,
               cuda_ms(bwd(chain.layer_bwd_plain)) / LAYERS),
        "K5": (cuda_ms(lambda: gram.pair_gram_fwd(*taps)),
               cuda_ms(lambda: gram.pair_gram_reference(*taps))),
    }
    for k, (ms, plain_ms) in times.items():
        print(f"  {k} time per launch: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    errs = {"K1": k1_err, "K2": k2_err, "K5": k5_err}
    return {k: dict(max_abs_err=errs[k], ms=times[k][0], plain_ms=times[k][1]) for k in errs}


def slice_phase(params, dev) -> None:
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

    cfg, spec = WaveNetAEConfig(), LossSpec(style_layer_ids=STYLE)
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
    print(f"[slice float32] loss card {float(lg):.6f} cpu {float(lc):.6f}")
    check("loss", lg, lc, 1e-4)
    # A relu gate within rounding of zero can flip between the two paths
    # (the K1 check above shows a few mask bytes in a million per layer);
    # a flip changes that element's cotangent by about its own size, so the
    # gradient is held in relative L2 norm rather than elementwise. On the
    # CPU alone, moving every trunk weight by one float32 ulp moves this
    # gradient by 8.9e-4 in relative L2, hence the tolerance of 5e-3.
    l2 = float((gg - gc).norm() / gc.norm())
    max_abs = float((gg - gc).abs().max())
    ok = l2 <= 5e-3
    print(f"  waveform gradient: rel L2 {l2:.3e} (tol 5e-03), max|d| {max_abs:.3e} "
          f"of max {float(gc.abs().max()):.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("waveform gradient: card and CPU paths disagree")


def cli_phase(dev) -> dict:
    """The port's CLI, 3 epochs of bf16 stack-0 transfer; counts launches."""
    import torch

    from audio_style_transfer_tpu.utils.audio_io import write_wav
    from audio_style_transfer_tpu_torch.cli.transfer import main
    from audio_style_transfer_tpu_torch.ops import _build

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "src")
        os.makedirs(src)
        write_wav(os.path.join(src, "content.wav"), synth_audio(3.0, kind="content"), 16000)
        write_wav(os.path.join(src, "style.wav"), synth_audio(3.0, kind="style"), 16000)
        argv = ["content", "style", "--dir", src, "--outdir", os.path.join(tmp, "out"),
                "--logdir", os.path.join(tmp, "log"), "--stack", "0",
                "--precision", "bfloat16", "--fused", "--random_init", "--no_artifacts",
                "--epochs", "3", "--device", str(dev)]
        print(f"[cli] {' '.join(argv[:2])} {' '.join(argv[8:])}")
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
        raise AssertionError("the CLI printed no epoch lines")
    losses = [float(r[2]) for r in rows]
    evals = sum(int(r[1]) for r in rows)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite losses {losses}")
    if any(b > a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"losses increase across epochs: {losses}")
    if audio.shape != (T,) or not np.all(np.isfinite(audio)):
        raise AssertionError("the CLI's output waveform is not finite [16384]")
    for k, v in launches.items():
        if v == 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")
    print(f"[cli] {len(rows)} epochs, losses {losses}, {evals} L-BFGS evals in "
          f"{wall:.2f} s wall ({evals / wall:.2f} evals/s, setup included); "
          f"launches {launches}")
    return launches


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
    slice_phase(params, dev)
    launches = cli_phase(dev)

    meta = {
        "K1": ("trunk forward layer", "audio_style_transfer_tpu_torch/csrc/trunk.cu",
               "audio_style_transfer_tpu/ops/pallas_chain.py:521"),
        "K2": ("trunk backward layer", "audio_style_transfer_tpu_torch/csrc/trunk.cu",
               "audio_style_transfer_tpu/ops/pallas_chain.py:672"),
        "K5": ("pair gram forward", "audio_style_transfer_tpu_torch/csrc/gram.cu",
               "audio_style_transfer_tpu/ops/pallas_gram.py:72"),
    }
    kernels = []
    for k, (name, source, replaces) in meta.items():
        r = results["bfloat16"][k]
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
