"""The real-tap stream FIR's share of its roofline (the FM-video modes'
pre-emphasis): the least time of its passes, their bytes and operations
counted from the stage's shapes at the card's peaks, over the device
time of the kernels named below, in %."""

import re

from harness.peaks import kernel_roofline_pct

KERNEL = re.compile(r"stream_fir_kernel<1,")


def read(ctx):
    return kernel_roofline_pct(ctx, KERNEL, 1)
