"""The port's benchmark: one cell, one seed, one run.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (BENCHMARK.json) names a
configuration and a traffic mix; set-up builds or loads the kernel library
(``build/kernels`` in the checkout), makes the weights on the card from the
seed, makes the traffic, and warms the cell's own shapes. Then the window
runs for ``--seconds``. With ``--trace 0`` the last line of standard output
is the cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics,
read from host spans over the window and a ``torch.profiler`` capture of one
more unit of work after it. After the window the program's state is freed
and the plain float32 reference judges what the window produced; each number
compared is printed beside its limit on standard error, and in the result's
last key. There is no CPU fallback: without the card the run fails.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "audio_style_transfer_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def environment() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths; one
    host thread for the CPU's share of the work (the eager launches and
    L-BFGS's host scalars run on one thread anyway, and idle OpenMP workers
    spinning beside it made the host-bound cell's runs spread)."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, "1")


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """Each reading beside its limit; correct when every reading is at or
    under its limit (a reading without a limit fails)."""
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in readings.items()}
    ok = all(c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float | None = None, trace_dir: str | None = None) -> dict:
    """Run one cell and return the result's dict (the last line's keys)."""
    import torch

    from portbench import spec
    from portbench.trace import capture

    t_start = T_START if t_start is None else t_start
    work = cell.kind.Workload(cell, seed, device)
    work.setup()
    setup_s = time.perf_counter() - t_start
    if trace:
        work.install_spans()
    work.run_window(seconds)
    metrics, breakdown, dev_extra = {}, None, {}
    if not trace:
        values = dict(work.end_to_end(), setup_s=setup_s)
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        spans = work.span_readings()
        context = dict(work.trace_context(), spans=spans, cell=cell.name)
        t = capture(work.profile_unit, device, context,
                    trace_dir or os.environ.get("PORTBENCH_TRACE_DIR"))
        work.uninstall_spans()
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(t)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        breakdown = t.breakdown()
        dev_extra = {"busy_s": t.busy_s, "window_s": t.window_s}
    on_card = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    attempted, failed = work.attempted()
    work.free()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    correct, checks = judge(work.readings(), cell.limits)
    result = {
        "correct": bool(correct and failed == 0),
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": cell.chips, "memory_peak_bytes": peak, **dev_extra},
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    environment()
    from portbench import spec

    cell = spec.resolve(spec.load_benchmark(ROOT), args.workload, ROOT)
    import torch

    torch.set_num_threads(1)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s) (NVIDIA H100); "
              f"torch.cuda sees {have} (is_available: {torch.cuda.is_available()}). "
              "There is no CPU fallback.", file=sys.stderr)
        return 2
    print(f"portbench: {cell.name} seed {args.seed} on {power_limit()}", file=sys.stderr)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}, which the port's benchmark may not load",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        verdict = "ok" if c["limit"] is not None and c["value"] <= c["limit"] else "FAILS"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
