"""L-BFGS's own host time per evaluation: the calls of ``lbfgs_minimize``
less their evaluations, over the window's evaluations (host spans)."""

from portbench.readers import span


def read(t):
    return span(t, "lbfgs_host_ms")
