"""Wall time of one loss + gradient evaluation, ended by a synchronise,
the mean over the window's evaluations (host spans)."""

from portbench.readers import span


def read(t):
    return span(t, "eval_ms")
