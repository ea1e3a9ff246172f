"""Arithmetic shared by the per-layer readers (``metrics/<name>.py``).

A reader takes the traced run's ``Trace`` (its ``context`` holds the cell's
configuration, the rows of a launch, the measured window's units of work and
seconds, and the host spans' readings) and returns a number, or None where
it finds nothing to read.
"""

from __future__ import annotations

from portbench import counts
from portbench.spans import EVAL_RANGE
from portbench.trace import Trace, is_own, is_product

ADAM_RANGE = "adam and ema"
RECOMPUTE_RANGE = "trunk weight recompute"


def idle_share(t: Trace):
    if t.window_s <= 0 or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def per_unit_ms(t: Trace, ops) -> float | None:
    if not ops or not t.units:
        return None
    return t.seconds(ops) / t.units * 1e3


def mfu(t: Trace, ops_per_unit: float) -> float | None:
    ctx = t.context
    if not ctx.get("window_units") or not ctx.get("window_s"):
        return None
    dt = ctx["config"]["compute_dtype"]
    return 100.0 * ops_per_unit * ctx["window_units"] / ctx["window_s"] / counts.PEAK_OPS_S[dt]


def span(t: Trace, key: str):
    return t.context.get("spans", {}).get(key)


def roofline(bound_s: float, ops) -> float | None:
    seconds = Trace.seconds(ops)
    if not ops or seconds <= 0:
        return None
    return 100.0 * bound_s / seconds


def trunk_roofline(t: Trace, evals_only: bool) -> float | None:
    """K1 and K2 (both its phases): the summed per-launch bounds over their
    device time. In a transfer only the evaluations' launches count (their
    rows are the cell's); in a training step every launch."""
    k1, k2, k2dx = t.named("K1"), t.named("K2"), t.named("K2dx")
    if evals_only:
        k1, k2, k2dx = (t.launched_in(EVAL_RANGE, ops) for ops in (k1, k2, k2dx))
    if not k1 or not k2:
        return None
    cfg, rows = t.context["config"], t.context["rows"]
    if evals_only:
        bound = counts.trunk_eval_bound_s(rows, cfg, len(k1), len(k2))
    else:
        dt, c = cfg["compute_dtype"], cfg["ae_width"]
        bound = (len(k1) * counts.bound_s(*counts.k1(rows, c, dt), dt)
                 + len(k2) * counts.bound_s(*counts.k2(rows, c, dt, False), dt))
    return roofline(bound, k1 + k2 + k2dx)


def gram_roofline(t: Trace) -> float | None:
    k5 = t.launched_in(EVAL_RANGE, t.named("K5"))
    k5r = t.launched_in(EVAL_RANGE, t.named("K5reduce"))
    k6 = t.launched_in(EVAL_RANGE, t.named("K6"))
    if not k5 or not k6:
        return None
    bound = counts.gram_eval_bound_s(t.context["rows"], t.context["config"], len(k5), len(k6))
    return roofline(bound, k5 + k5r + k6)


def step_kernels(t: Trace):
    """The kernels of the training steps outside the trunk's weight
    recompute."""
    inside = {id(e) for e in t.launched_in(RECOMPUTE_RANGE, t.kernels)}
    return [e for e in t.kernels if id(e) not in inside]


def decoder_products_roofline(t: Trace) -> float | None:
    products = [e for e in step_kernels(t) if is_product(e["name"])]
    if not products or not t.units:
        return None
    cfg = t.context["config"]
    bound = t.units * counts.products_bound_s(counts.decoder_products(t.context["rows"], cfg),
                                              cfg["compute_dtype"])
    return roofline(bound, products)


def decoder_elementwise_ms(t: Trace) -> float | None:
    adam = {id(e) for e in t.launched_in(ADAM_RANGE, t.kernels)}
    ops = [e for e in step_kernels(t)
           if not is_product(e["name"]) and not is_own(e["name"]) and id(e) not in adam]
    return per_unit_ms(t, ops)
