"""The device trace of the traced run.

``capture`` runs one unit of work (a clip, a group of steps) under
``torch.profiler`` (host and device activity), writes the Chrome trace, and
reads it back into a ``Trace``: the device operations (kernels, copies,
fills) with their launch correlation, the host's ranges (``record_function``
names), and the host ops that were running while the device sat idle. The
device's busy time is the union of its operations' intervals, so overlaps
count once (a copy of chip_smoke.py's ``device_busy``).
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

from portbench.common import clock, sync

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
# The program's hand-written kernels by the names of their CUDA functions
# (tools/profile_eval.py's table).
KERNELS = {"K1": ("trunk_fwd_mma", "trunk_fwd_kernel"),
           "K2": ("trunk_bwd_dy_mma", "trunk_bwd_dy_kernel"),
           "K2dx": ("trunk_bwd_dx_mma", "trunk_bwd_dx_kernel"),
           "K5": ("gram_fwd",), "K5reduce": ("gram_reduce",), "K6": ("gram_bwd",)}
PRODUCT_WORDS = ("gemm", "gemv", "xmma", "cutlass", "cublas", "nvjet")
OWN_WORDS = ("trunk_", "encoder_", "gram_")


def is_product(name: str) -> bool:
    n = name.lower()
    return any(w in n for w in PRODUCT_WORDS)


def is_own(name: str) -> bool:
    return any(w in name for w in OWN_WORDS)


def union_us(spans) -> tuple[float, list]:
    """(total length, merged intervals) of [start, end) spans."""
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


class Trace:
    def __init__(self, events: list, window_s: float, units: int, context: dict):
        self.window_s, self.units, self.context = window_s, units, context
        self.ops = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
        self.kernels = [e for e in self.ops if e["cat"] == "kernel"]
        self.launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                          if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
        self.ranges = defaultdict(list)
        for e in events:
            if e.get("cat") == "user_annotation" and "dur" in e:
                self.ranges[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
        self.host = sorted((e["ts"], e["ts"] + e.get("dur", 0.0), e["name"]) for e in events
                           if e.get("cat") in HOST_CATS and "dur" in e)
        busy, self.busy_intervals = union_us((e["ts"], e["ts"] + e["dur"]) for e in self.ops)
        self.busy_s = busy / 1e6

    def named(self, key: str) -> list:
        frags = KERNELS[key]
        return [e for e in self.kernels if any(f in e["name"] for f in frags)]

    def launched_in(self, range_name: str, ops: list) -> list:
        """The operations whose launch lies inside a host range of that name."""
        spans = sorted(self.ranges.get(range_name, ()))
        starts = [a for a, _ in spans]
        out = []
        for e in ops:
            ts = self.launch_ts.get(e.get("args", {}).get("correlation"))
            if ts is None:
                continue
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and ts <= spans[i][1]:
                out.append(e)
        return out

    @staticmethod
    def seconds(ops) -> float:
        return sum(e["dur"] for e in ops) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the device's idle
        time by the host op begun last before each gap (what the host was
        doing while the device waited)."""
        by_name = defaultdict(float)
        for e in self.ops:
            by_name[e["name"][:120]] += e["dur"] / 1e6
        starts = [h[0] for h in self.host]
        idle = defaultdict(float)
        for (_, g0), (g1, _) in zip(self.busy_intervals, self.busy_intervals[1:]):
            i = bisect.bisect_right(starts, g0) - 1
            idle[self.host[i][2][:120] if i >= 0 else "before the first host op"] += (g1 - g0) / 1e6
        order = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]  # noqa: E731
        return {"device_ops": order(by_name), "idle_gaps": order(idle)}


def capture(run_unit, device, context: dict, out_dir: str | None = None) -> Trace:
    """Profile ``run_unit()`` (it returns its count of units) and read the
    trace back."""
    from torch.profiler import ProfilerActivity, profile

    sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = clock()
        units = run_unit()
        sync(device)
        window_s = clock() - t0
    out_dir = out_dir or tempfile.gettempdir()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"portbench-trace-{context.get('cell', 'run')}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return Trace(events, window_s, units, context)
