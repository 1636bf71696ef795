"""ssim_sums_roofline: the least time of SSIMULACRA2's per-pair statistics
(B13, ``ssim_band_kernel``) for the op calls traced, over the device time of
the slice's ``ssim_band_kernel`` launches, in percent.

The least time of one call is the larger of two bounds (``traffic/cost.py``)
on the work the reference module counts for the stage,
``rec["cost"]["stages"]["ssim_sums"]`` (``reference/ssimulacra2.py``,
``stage_work``): every kept (scale, plane) pair's two XYB planes read once
and its band partials written, and the blurs, maps and sums term by term.
Kernels are matched by their function name, as ``h_stage_roofline`` matches
``h_fixed_kernel``.  Left out, never 0, where the slice is missing, holds no
such kernel, or the reference counts no such stage."""

from portbench.metrics.h_stage_roofline import matcher
from portbench.traffic.cost import least_ms

KERNELS = ("ssim_band_kernel",)
STAGE = "ssim_sums"


def read(rec):
    t = rec.get("trace")
    work = rec["cost"].get("stages", {}).get(STAGE)
    if not t or not t["calls"] or work is None:
        return None
    found = matcher(KERNELS)
    busy = sum(d["end"] - d["start"] for d in t["device"]
               if not d["copy"] and found.search(d["name"])) * 1e-6
    if busy <= 0:
        return None
    least, _ = least_ms(*work)
    return 100.0 * least * 1e-3 * t["calls"] / busy
