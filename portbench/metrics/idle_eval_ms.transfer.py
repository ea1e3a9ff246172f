"""Device idle ms per evaluation whose gap ends with an operation launched
inside an ``lbfgs.eval`` span (the evaluation's own dispatch)."""

from portbench.program_spans import idle_ms


def read(t):
    return idle_ms(t, "eval")
