"""K1 and K2 of the evaluations: the summed per-launch bounds over their
device time (counts.k1, counts.k2)."""

from portbench.readers import trunk_roofline


def read(t):
    return trunk_roofline(t, evals_only=True)
