"""Readings of the program's own spans in the traced run's capture.

The port opens ``torch.profiler`` ranges at the layer boundaries of the
transfer path (``audio_style_transfer_tpu_torch/utils/profiling.py::span``):

* ``transfer.targets``: a clip's content and style targets, before its epochs;
* ``lbfgs.minimize``: one call of ``lbfgs_minimize`` (an epoch);
* ``lbfgs.eval``: one call of the objective inside it (its dispatch);
* ``lbfgs.host_read``: one read of a device value on the host inside it (a
  sync with the device).

They share the capture's clock with the kernels and the runtime calls, so a
kernel is put down to the span that holds its launch. These readers use the
``Trace``'s ``ranges``, ``launch_ts``, ``kernels``, ``ops``,
``busy_intervals`` and ``window_s`` only, and return None where the capture
holds no such span (a program without them). "Per evaluation" divides by the
count of ``lbfgs.eval`` spans in the capture.
"""

from __future__ import annotations

import bisect

from portbench.trace import Trace, union_us

TARGETS = "transfer.targets"
MINIMIZE = "lbfgs.minimize"
EVAL = "lbfgs.eval"
HOST_READ = "lbfgs.host_read"
# Where an idle gap is put down, innermost first: the evaluation, the rest of
# L-BFGS (its host reads included), the targets; "none" outside them all.
LAYERS = (("eval", EVAL), ("lbfgs", MINIMIZE), ("targets", TARGETS))


def evals(t: Trace) -> int:
    return len(t.ranges.get(EVAL, ()))


def _per_eval(t: Trace, value: float) -> float | None:
    n = evals(t)
    return value / n if n else None


def _inside(spans: list, ts: float) -> bool:
    """Whether ``ts`` lies in one of ``spans``, sorted [start, end) pairs that
    do not overlap (one name's spans on one thread)."""
    i = bisect.bisect_right(spans, (ts, float("inf"))) - 1
    return i >= 0 and ts <= spans[i][1]


def _launch(t: Trace, op: dict) -> float | None:
    return t.launch_ts.get(op.get("args", {}).get("correlation"))


def _total_us(spans) -> float:
    return sum(b - a for a, b in spans)


def host_reads_per_eval(t: Trace) -> float | None:
    reads = t.ranges.get(HOST_READ)
    return _per_eval(t, len(reads)) if reads else None


def host_read_ms(t: Trace) -> float | None:
    """Host ms per evaluation inside ``lbfgs.host_read``: the host blocked on
    the device."""
    reads = t.ranges.get(HOST_READ)
    return _per_eval(t, _total_us(reads) / 1e3) if reads else None


def eval_dispatch_ms(t: Trace) -> float | None:
    """Host ms per evaluation inside ``lbfgs.eval``: the objective's
    dispatch, which ends before its value is read."""
    return _per_eval(t, _total_us(t.ranges.get(EVAL, ())) / 1e3)


def lbfgs_self_ms(t: Trace) -> float | None:
    """Host ms per evaluation inside ``lbfgs.minimize`` that neither an
    ``lbfgs.eval`` nor an ``lbfgs.host_read`` span covers: L-BFGS's own
    Python and launches."""
    outer = t.ranges.get(MINIMIZE)
    if not outer or not evals(t):
        return None
    children = t.ranges.get(EVAL, []) + t.ranges.get(HOST_READ, [])
    self_us = 0.0
    for a, b in outer:
        covered, _ = union_us((max(c0, a), min(c1, b)) for c0, c1 in children
                              if c0 < b and c1 > a)
        self_us += (b - a) - covered
    return _per_eval(t, self_us / 1e3)


def lbfgs_launches_per_eval(t: Trace) -> float | None:
    """Kernels launched inside ``lbfgs.minimize`` but outside its
    ``lbfgs.eval`` spans, per evaluation: the optimizer's own launches."""
    outer = sorted(t.ranges.get(MINIMIZE, ()))
    inner = sorted(t.ranges.get(EVAL, ()))
    if not outer or not inner:
        return None
    own = 0
    for k in t.kernels:
        ts = _launch(t, k)
        own += ts is not None and _inside(outer, ts) and not _inside(inner, ts)
    return _per_eval(t, own)


def _layer(spans: dict, ts: float | None) -> str:
    """The innermost of ``LAYERS`` whose span (``spans``: name -> sorted
    spans) holds the launch at ``ts``."""
    if ts is not None:
        for layer, name in LAYERS:
            if _inside(spans[name], ts):
                return layer
    return "none"


def idle_by_layer(t: Trace) -> dict | None:
    """The capture's device idle, in us, by the layer of ``LAYERS`` that
    launched the device operation ending each gap ("none": no span holds
    that launch).

    The capture's window (``window_s``, on the host's clock) is placed on the
    trace's clock so that it ends where the device's last operation ends:
    the capture closes on a synchronise. The gap before the first operation
    is then the window's start to that operation, and the gaps sum to
    ``window_s`` less the device's busy time, the idle that
    ``device_idle.transfer`` reads."""
    if not t.ops or not evals(t):
        return None
    intervals = t.busy_intervals
    first_at = {}
    for e in sorted(t.ops, key=lambda e: (e["ts"], _launch(t, e) or 0.0)):
        first_at.setdefault(e["ts"], e)
    spans = {name: sorted(t.ranges.get(name, ())) for _, name in LAYERS}
    out = dict.fromkeys([layer for layer, _ in LAYERS] + ["none"], 0.0)
    start = intervals[-1][1] - t.window_s * 1e6
    ends = [start] + [b for _, b in intervals[:-1]]
    for g0, (g1, _) in zip(ends, intervals):
        if g1 > g0:
            out[_layer(spans, _launch(t, first_at[g1]))] += g1 - g0
    return out


def idle_ms(t: Trace, layer: str) -> float | None:
    """Device idle ms per evaluation put down to ``layer``."""
    idle = idle_by_layer(t)
    return None if idle is None else _per_eval(t, idle[layer] / 1e3)


def targets_ms(t: Trace) -> float | None:
    """Device ms of the kernels launched inside ``transfer.targets``, per
    ``transfer.targets`` span."""
    spans = t.ranges.get(TARGETS)
    if not spans:
        return None
    launched = t.launched_in(TARGETS, t.kernels)
    return Trace.seconds(launched) * 1e3 / len(spans) if launched else None
