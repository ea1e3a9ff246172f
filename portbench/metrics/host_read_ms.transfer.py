"""Host ms per evaluation inside the program's ``lbfgs.host_read`` spans:
L-BFGS blocked on the device (its reads of f, the slopes and the curvature
pairs wait for the work queued before them)."""

from portbench.program_spans import host_read_ms


def read(t):
    return host_read_ms(t)
