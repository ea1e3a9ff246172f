"""Device ms per evaluation of everything launched inside the program's
``gram.pair`` and ``gram.pair_bwd`` spans (ops/gram.py: K5, its reduce, K6,
and h = g + g^T with its cast and what the route allocates around them)
during the evaluations. A program without the spans reads nothing."""

from portbench.readers import per_unit_ms
from portbench.spans import EVAL_RANGE


def read(t):
    ops = t.launched_in("gram.pair", t.ops) + t.launched_in("gram.pair_bwd", t.ops)
    return per_unit_ms(t, t.launched_in(EVAL_RANGE, ops))
