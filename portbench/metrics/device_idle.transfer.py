"""The share of the captured clip in which the device ran nothing."""

from portbench.readers import idle_share


def read(t):
    return idle_share(t)
