"""Host ms per evaluation inside ``lbfgs.minimize`` that neither an
``lbfgs.eval`` nor an ``lbfgs.host_read`` span covers: L-BFGS's own work."""

from portbench.program_spans import lbfgs_self_ms


def read(t):
    return lbfgs_self_ms(t)
