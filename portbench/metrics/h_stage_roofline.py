"""h_stage_roofline: the least time of BoxBlur's horizontal passes (B2,
``h_fixed_kernel``) for the op calls traced, over the device time of the
slice's ``h_fixed_kernel`` launches, in percent.

The least time of one call is the larger of two bounds (``traffic/cost.py``):
the bytes of every plane read once and written once, ``rec["cost"]["bytes"]``,
and the axis's operations over the peaks.  ``rec["cost"]`` holds the op's
totals only, so the axis takes ``AXIS_SHARE`` of them, a half: the cells
this metric reads run as many passes of one radius in each axis, and the
plugin's formulas cost the same a sample and pass in either axis
(``reference/boxblur_rt.py``, ``work_by_axis``).

Kernels are matched by their own function name in the profiler's demangled
name, never by a substring: ``v_stage_roofline``'s ``v_chip_kernel`` is not
``ct_v_chip_kernel`` (B1's vertical stage).  Left out, never 0, where the
slice is missing or holds none of the axis's kernels."""

import re

from portbench.traffic.cost import least_ms

AXIS_SHARE = 0.5
KERNELS = ("h_fixed_kernel",)


def matcher(names):
    """A pattern that finds any of the kernel function `names` in a demangled
    name (``void (anonymous namespace)::h_fixed_kernel<unsigned short,
    false>(...)``), preceded by no identifier character."""
    return re.compile(r"(?<![A-Za-z0-9_])(?:%s)(?=[<(]|$)" % "|".join(map(re.escape, names)))


def stage_share(rec, names):
    """The axis's least time for the slice's calls over the device time of
    its kernels `names`, in percent; None where there is nothing to read."""
    t = rec.get("trace")
    if not t or not t["calls"]:
        return None
    found = matcher(names)
    busy = sum(d["end"] - d["start"] for d in t["device"]
               if not d["copy"] and found.search(d["name"])) * 1e-6
    if busy <= 0:
        return None
    c = rec["cost"]
    least, _ = least_ms(c["bytes"], c["int_ops"] * AXIS_SHARE, c["f32_ops"] * AXIS_SHARE)
    return 100.0 * least * 1e-3 * t["calls"] / busy


def read(rec):
    return stage_share(rec, KERNELS)
