"""The program's ``lbfgs.host_read`` spans per ``lbfgs.eval`` span in the
captured clip: L-BFGS's syncs with the device per evaluation."""

from portbench.program_spans import host_reads_per_eval


def read(t):
    return host_reads_per_eval(t)
