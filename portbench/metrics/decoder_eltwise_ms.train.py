"""Device ms per step in kernels that are neither matrix products nor the
program's own, and lie neither under ``adam and ema`` nor under the trunk's
weight recompute: the decoder's elementwise passes."""

from portbench.readers import decoder_elementwise_ms


def read(t):
    return decoder_elementwise_ms(t)
