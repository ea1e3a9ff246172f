"""Device ms per step under the program's ``adam and ema`` range."""

from portbench.readers import ADAM_RANGE, per_unit_ms


def read(t):
    return per_unit_ms(t, t.launched_in(ADAM_RANGE, t.kernels))
