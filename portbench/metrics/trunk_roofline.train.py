"""K1 and K2 of the training steps: the summed per-launch bounds over their
device time."""

from portbench.readers import trunk_roofline


def read(t):
    return trunk_roofline(t, evals_only=False)
