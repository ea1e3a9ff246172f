"""Device kernels launched inside L-BFGS (its evaluations and its own
work) per evaluation, in the captured clip; the clip's targets left out."""

from portbench.spans import LBFGS_RANGE


def read(t):
    launched = t.launched_in(LBFGS_RANGE, t.kernels)
    if not t.units or not launched:
        return None
    return len(launched) / t.units
