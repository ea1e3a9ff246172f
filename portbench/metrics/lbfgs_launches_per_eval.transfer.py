"""Kernels launched inside ``lbfgs.minimize`` and outside its ``lbfgs.eval``
spans, per evaluation: the optimizer's own launches (two-loop, line search,
curvature pairs)."""

from portbench.program_spans import lbfgs_launches_per_eval


def read(t):
    return lbfgs_launches_per_eval(t)
