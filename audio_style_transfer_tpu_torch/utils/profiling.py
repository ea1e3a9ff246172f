"""Spans, device traces and scalar metrics (counterpart of
audio_style_transfer_tpu/utils/profiling.py).

The reference has no tracing at all: wall-clock prints in the L-BFGS
callback (reference methods.py:151-155) and TensorBoard scalars
(methods.py:127-130). This module provides:

* ``span(name)``: a named range of the program, recorded on the
  profiler's clock while a capture runs and free of cost otherwise (the
  names and the metrics that read them: PERF.md, section 3);
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

from torch._C._autograd import _profiler_enabled
from torch.profiler import record_function

# One object for every span while no capture is running: entering it does
# nothing and allocates nothing.
_OFF = contextlib.nullcontext()


def span(name: str):
    """A named range of the program on the ``torch.profiler`` clock.

    Inside a capture (``device_trace``, or any ``torch.profiler.profile``)
    this is ``record_function(name)``: the range lands in the trace as a
    ``user_annotation`` event on the clock of the CUDA kernels and runtime
    calls, so device time and idle gaps can be put down to it. Outside one
    it costs one check of the profiler's state and nothing else::

        with span("lbfgs.eval"):
            f, g = value_and_grad(x)
    """
    return record_function(name) if _profiler_enabled() else _OFF


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
