"""The decoder's products (and the bottleneck's): their summed bounds from
the shapes (counts.decoder_products) over the device time of the step's
matrix products outside the trunk's weight recompute."""

from portbench.readers import decoder_products_roofline


def read(t):
    return decoder_products_roofline(t)
