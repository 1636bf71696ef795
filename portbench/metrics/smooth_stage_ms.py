"""smooth_stage_ms: the median, over the op calls traced, of the device time
of the operations that MosquitoNR's smoothing stage launched (the span
``vszip.op.mosquito_nr.smooth``: the lift, the pad, the SADs, the choice and
the blend), in ms.

A device operation is tied to the host's range it was launched from.  The
calls are the harness's ``portbench.op`` ranges, on the host and, as the
profiler puts each on the device's timeline, from its first operation's
start to its last's end (``rec["trace"]["ops"]``), in order.  In each call
the CUDA runtime calls that put work on the device (``LAUNCHES``: kernel
launches, copies, memsets) are taken in start order, each with the stage
range that holds it, or none; they pair one to one, in order, with the
call's device operations in start order: the op runs on one stream, which
executes in issue order.  A call's stage time is the sum of its stage's
operations' device times.

A call whose launches and device operations differ in number is left out:
the profiler has lost one of its operations, or put it outside the slice.
On an H100 the profiler lost the first operation of the slice in every
slice of the 30-s runs traced.
The metric is left out, never 0, where the slice is missing, where no range
of the stage is in it (a program without the stage spans), where the calls
on the host and on the device differ in number, or where no call pairs."""

import bisect
import statistics

from portbench.trace import OP_RANGE

STAGE = "vszip.op.mosquito_nr.smooth"
# CUDA runtime (`cuda*`) and low-level (`cu*`) calls that enqueue device work,
# by name prefix
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel", "cuLaunchKernel",
            "cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset")


def _inside(ranges, s, e):
    """The index of the range of sorted, disjoint `ranges` that holds [s, e],
    or None."""
    i = bisect.bisect_right(ranges, (s, float("inf"))) - 1
    return i if i >= 0 and ranges[i][0] <= s and e <= ranges[i][1] else None


def _outermost(ranges):
    """`ranges` sorted by start, those held by an earlier one left out."""
    out = []
    for s, e in sorted(ranges, key=lambda r: (r[0], -r[1])):
        if not out or s >= out[-1][1]:
            out.append((s, e))
    return out


def stage_ms(rec, stage):
    """The median over the slice's calls of stage `stage`'s device ms a call;
    None where there is nothing to read."""
    t = rec.get("trace")
    if not t or not t.get("window") or not t["calls"]:
        return None
    w0, w1 = t["window"]
    in_window = [(name, s, e) for name, s, e in t["cpu"] if w0 <= s and e <= w1]
    spans = _outermost((s, e) for name, s, e in in_window if name == stage)
    calls = _outermost((s, e) for name, s, e in in_window if name == OP_RANGE)
    on_device = sorted(t["ops"])
    if not spans or not calls or len(calls) != len(on_device):
        return None
    # a launch made from inside another (`cuLaunchKernel` under
    # `cudaLaunchKernel`) enqueues one operation
    launches = _outermost((s, e) for name, s, e in in_window if name.startswith(LAUNCHES))
    # an operation belongs to the call whose device range holds its middle:
    # the ends of the two are equal only to the rounding of the profiler's
    # microseconds, a quarter of one at today's clock values
    ops = [[] for _ in calls]
    for d in sorted(t["device"], key=lambda d: d["start"]):
        middle = (d["start"] + d["end"]) / 2
        k = _inside(on_device, middle, middle)
        if k is not None:
            ops[k].append(d)
    per_call = []
    for (cs, ce), mine_ops in zip(calls, ops):
        lo, hi = bisect.bisect_left(launches, (cs,)), bisect.bisect_left(launches, (ce,))
        mine = [r for r in launches[lo:hi] if r[1] <= ce]
        if len(mine) != len(mine_ops):
            continue
        per_call.append(sum(d["end"] - d["start"] for (s, e), d in zip(mine, mine_ops)
                            if _inside(spans, s, e) is not None))
    return statistics.median(per_call) * 1e-3 if per_call else None


def read(rec):
    return stage_ms(rec, STAGE)
