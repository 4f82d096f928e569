"""The warp kernels' share of their roofline over the traced units: the
least time of the warp applications the reference counts at the cell's
shapes (forward, and the grid's and the features' gradients where the
application is differentiated) over the device time of the kernels whose
names match ``PATTERN``."""

from portbench.readers import WARP_KERNELS, roofline_pct

PATTERN = WARP_KERNELS


def read(r):
    return roofline_pct(r, PATTERN)
