"""Phase timing, device traces and scalar metrics (counterpart of
audio_style_transfer_tpu/utils/profiling.py).

The reference has no tracing at all: wall-clock prints in the L-BFGS
callback (reference methods.py:151-155) and TensorBoard scalars
(methods.py:127-130). This module provides:

* ``phase(name)``: nested wall-clock phase timing with a report;
* ``device_trace(logdir)``: a ``torch.profiler`` capture of the host and,
  where a CUDA device is present, the device, written to ``logdir`` as a
  Chrome trace (chrome://tracing, Perfetto, TensorBoard's profile plugin);
* ``MetricsLogger``: scalar time series as JSONL, in place of tf.summary
  scalars.

The JAX module's ``enable_compile_cache`` (XLA's persistent compilation
cache) and ``summarize_xplane`` (a parser of XLA's xplane protobuf) have no
counterpart: the port compiles no XLA programs, and a Chrome trace is read
with ``torch.profiler``'s own ``key_averages()``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict


class PhaseTimer:
    """Nested wall-clock phase accounting."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._stack: list[str] = []

    @contextlib.contextmanager
    def phase(self, name: str):
        full = "/".join(self._stack + [name])
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._stack.pop()
            self.totals[full] += time.perf_counter() - t0
            self.counts[full] += 1

    def report(self) -> str:
        lines = ["phase timings:"]
        for name in sorted(self.totals):
            lines.append(
                f"  {name}: {self.totals[name]:.3f}s over {self.counts[name]} call(s)"
            )
        return "\n".join(lines)


_GLOBAL_TIMER = PhaseTimer()


def phase(name: str):
    """Global convenience: ``with profiling.phase('style_phi'): ...``."""
    return _GLOBAL_TIMER.phase(name)


def report() -> str:
    return _GLOBAL_TIMER.report()


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the block (host operations, and
    CUDA kernels when a CUDA device is present) and write it to
    ``<logdir>/trace-<pid>-<ns>.json`` as a Chrome trace. Yields the logdir."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


class MetricsLogger:
    """Scalar metrics to JSONL; stands in for tf.summary.scalar streams."""

    def __init__(self, logdir: str, filename: str = "metrics.jsonl"):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, filename)
        self._f = open(self.path, "a")

    def log(self, step: int, **scalars: float) -> None:
        rec = {"step": int(step)}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
