"""The share of the captured group of steps in which the device ran
nothing."""

from portbench.readers import idle_share


def read(t):
    return idle_share(t)
