"""Device ms per evaluation of everything launched inside the program's
``gram.layer`` and ``gram.layer_bwd`` spans (ops/gram.py: K8f, its sum, K8b
and what the route allocates and casts around them) during the evaluations.
A program without the spans reads nothing."""

from portbench.readers import per_unit_ms
from portbench.spans import EVAL_RANGE


def read(t):
    ops = t.launched_in("gram.layer", t.ops) + t.launched_in("gram.layer_bwd", t.ops)
    return per_unit_ms(t, t.launched_in(EVAL_RANGE, ops))
