"""v_stage_roofline: the least time of BoxBlur's vertical passes (B3,
``v_chip_kernel``, or its column walk ``v_fixed_kernel`` where the rings do
not fit) for the op calls traced, over the device time of the slice's
launches of those kernels, in percent.  The least time and the match by
function name are ``h_stage_roofline``'s: half of the op's operations over the
peaks, or every plane read and written once, whichever is larger.  Left out,
never 0, where the slice is missing or holds none of these kernels."""

from portbench.metrics.h_stage_roofline import stage_share

KERNELS = ("v_chip_kernel", "v_fixed_kernel")


def read(rec):
    return stage_share(rec, KERNELS)
