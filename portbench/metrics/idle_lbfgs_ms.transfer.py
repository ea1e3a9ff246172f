"""Device idle ms per evaluation whose gap ends with an operation launched by
L-BFGS's own code (inside ``lbfgs.minimize``, outside ``lbfgs.eval``)."""

from portbench.program_spans import idle_ms


def read(t):
    return idle_ms(t, "lbfgs")
