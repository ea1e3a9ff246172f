"""Where a bfloat16 loss+gradient evaluation spends its time on the GPU.

Run from the repository root on a machine with one CUDA device:

    python3 -m audio_style_transfer_tpu_torch.tools.profile_eval

For each path (stack 0, stack 0 with the wavefront backward on, the full
stack, the full stack with per-layer blocks; full width, T=16384, random weights from seed 0, the clips and the
targets of chip_smoke.py) it prints
  - the bare evaluation: CUDA events and the host clock over 30 evaluations;
  - the evaluation inside L-BFGS: one epoch of maxiter 30 from the 1e-6 start
    with the engine's zoom search, host clock over its evaluations, set-up
    excluded;
  - torch.profiler over 10 bare evaluations: device time per evaluation, in
    all and by kernel, kernel launches per evaluation, and the busy share
    (device time over the bare and over the in-L-BFGS evaluation time);
  - on the wavefront path first, the bare evaluation of the same engine with
    the switch off, on, on, off: the paired comparison (the host clock of a
    path also depends on the paths before it in the process).
Every line carries the card's name and power limit.
"""

from __future__ import annotations

import subprocess
import sys
import time

import torch

import chip_smoke as cs  # clips, make_eval, bare_eval_ms; found from the repository root
from audio_style_transfer_tpu_torch.models.wavenet_ae import WaveNetAEConfig, init_params
from audio_style_transfer_tpu_torch.ops import chain
from audio_style_transfer_tpu_torch.transfer import lbfgs

PATHS = {"stack 0": cs.EVAL_PATHS["stack 0"],
         "stack 0, chained, wavefront on": cs.EVAL_PATHS["stack 0"],
         "full stack": cs.EVAL_PATHS["full stack"],
         "full stack, per-layer": dict(stack=None, cont_lyr_ids=(25,), chain_encoder=False)}
# Paths that run with the wavefront backward (K2-wf groups) switched on.
WAVEFRONT = {"stack 0, chained, wavefront on"}
# Kernel-name fragments of the hand-written kernels, for the summary line.
OURS = {"K1/K7f mma": "trunk_fwd_mma", "K2 dy mma": "trunk_bwd_dy_mma",
        "K7b dy mma": "encoder_bwd_dy_mma", "K2/K7b dx mma": "trunk_bwd_dx_mma",
        "K1/K7f fma": "trunk_fwd_kernel", "K2 dy fma": "trunk_bwd_dy_kernel",
        "K7b dy fma": "encoder_bwd_dy_kernel", "K2/K7b dx fma": "trunk_bwd_dx_kernel",
        "K2-wf mma": "trunk_bwd_wf_mma", "K2-wf fma": "trunk_bwd_wf_kernel", "K5": "gram_fwd", "K5 reduce": "gram_reduce",
        "K6": "gram_bwd"}
PROFILED_EVALS = 10


def device_rows(prof) -> dict:
    """Kernel name -> (self device microseconds, launches) of a profile."""
    rows = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        was = rows.get(e.key, (0.0, 0))
        rows[e.key] = (was[0] + us, was[1] + e.count)
    if not rows or sum(r[0] for r in rows.values()) <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_eval: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    params = init_params(0, WaveNetAEConfig())
    for label, path in PATHS.items():
        chain._BWD_WAVEFRONT = label in WAVEFRONT
        vg, x = cs.make_eval(params, dev, **path)
        if label in WAVEFRONT:
            paired = []
            for on in (False, True, True, False):
                chain._BWD_WAVEFRONT = on
                paired.append(cs.bare_eval_ms(vg, x)[0])
            chain._BWD_WAVEFRONT = True
            print(f"[{label}] bare eval, the same engine with the wavefront off, on, on, off: "
                  + ", ".join(f"{ms:.3f}" for ms in paired) + f" ms ({smi})")
        device_ms, host_ms = cs.bare_eval_ms(vg, x)
        print(f"[{label}] bare eval: device {device_ms:.3f} ms, host {host_ms:.3f} ms ({smi})")

        x0 = torch.full((cs.T,), 1e-6, device=dev)
        opts = lbfgs.LBFGSOptions(maxiter=30, line_search="zoom", restart_on_ls_fail=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = lbfgs.lbfgs_minimize(vg, x0, opts)
        torch.cuda.synchronize()
        loop_ms = (time.perf_counter() - t0) * 1e3 / res.n_evals
        print(f"[{label}] in L-BFGS: {loop_ms:.3f} ms per eval over {res.n_evals} evals, "
              f"{1e3 / loop_ms:.2f} evals/s, final loss {float(res.f):.4f} ({smi})")

        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED_EVALS):
                vg(x)
            torch.cuda.synchronize()
        rows = device_rows(prof)
        total_ms = sum(r[0] for r in rows.values()) / 1e3 / PROFILED_EVALS
        launches = sum(r[1] for r in rows.values()) / PROFILED_EVALS
        print(f"[{label}] device time per eval {total_ms:.3f} ms in {launches:.0f} launches; "
              f"busy share {total_ms / host_ms:.3f} of the bare eval, "
              f"{total_ms / loop_ms:.3f} of the in-L-BFGS eval ({smi})")
        ours = {k: sum(us for name, (us, _) in rows.items() if frag in name) / 1e3
                / PROFILED_EVALS for k, frag in OURS.items()}
        ours = {k: round(v, 4) for k, v in ours.items() if v > 0}
        rest = total_ms - sum(ours.values())
        print(f"[{label}] ms per eval by hand-written kernel {ours}, everything else "
              f"{rest:.3f} ms")
        for name, (us, n) in sorted(rows.items(), key=lambda kv: -kv[1][0])[:8]:
            print(f"    {us / 1e3 / PROFILED_EVALS:8.4f} ms  {n / PROFILED_EVALS:6.1f} launches  "
                  f"{name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
