"""Host ms per evaluation inside the program's ``lbfgs.eval`` spans: the
dispatch of the loss and its gradient, up to the read of the loss."""

from portbench.program_spans import eval_dispatch_ms


def read(t):
    return eval_dispatch_ms(t)
