"""op_host_ms: the median host time of one op call over the traced slice: the
duration of each outermost ``vszip.op.*`` range of the program (a public op
called from outside any other, with its validation, derivation, dispatch and
launches) that lies inside the slice, less the profiler's own stalls inside
it (``dispatch_idle_share.STALLS``: buffer requests, and waits for room in
a full launch queue, which follow the device's pace and not the host's), in
ms.  Left out where the slice or the program's ranges are missing."""

import statistics

from portbench.metrics.dispatch_idle_share import STALLS, overlap, ranges

PREFIX = "vszip.op."


def outermost(cpu, window):
    """(start, end) of the `PREFIX` ranges of `cpu` inside `window` that no
    other such range holds."""
    calls = sorted(((s, e) for name, s, e in cpu
                    if name.startswith(PREFIX) and s >= window[0] and e <= window[1]),
                   key=lambda r: (r[0], -r[1]))
    out = []
    for s, e in calls:
        if not out or s >= out[-1][1]:
            out.append((s, e))
    return out


def read(rec):
    t = rec.get("trace")
    if not t or not t.get("window"):
        return None
    calls = outermost(t["cpu"], t["window"])
    if not calls:
        return None
    stalls, _ = ranges(t["cpu"], t["window"], lambda n: n in STALLS)
    return statistics.median(e - s - overlap([[s, e]], stalls) for s, e in calls) * 1e-3
