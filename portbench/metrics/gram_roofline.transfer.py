"""K5 (with its reduce) and K6 of the evaluations: the summed per-launch
bounds over their device time (counts.k5, counts.k6)."""

from portbench.readers import gram_roofline


def read(t):
    return gram_roofline(t)
