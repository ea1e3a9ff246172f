"""Device ms of the kernels launched inside ``transfer.targets``, per span:
one clip's content and style targets."""

from portbench.program_spans import targets_ms


def read(t):
    return targets_ms(t)
