"""dispatch_idle_share: the share of the traced slice in which the device was
idle (no kernel or copy running: outside the merged device intervals) while
the host was inside one of the program's ``vszip.`` ranges, and not in one
of the profiler's own stalls, in percent: the card's time that the
program's own host work leaves idle.  Left out where the slice or the
program's ranges are missing."""

from portbench.trace import union

PREFIX = "vszip."
# what CUPTI records of its own cost on the host: a request for a new
# activity buffer, and CUDA waiting for room in a full launch queue,
# which a profiled run fills sooner
STALLS = ("Activity Buffer Request", "Command Buffer Full")


def overlap(a, b):
    """Total length common to two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def ranges(cpu, window, keep):
    """The merged intervals of the CPU ranges whose name `keep` accepts,
    clipped to `window`, and their total length."""
    return union([{"start": s, "end": e} for name, s, e in cpu
                  if keep(name) and e > window[0] and s < window[1]], window)


def read(rec):
    t = rec.get("trace")
    if not t or not t.get("window") or t["window_s"] <= 0:
        return None
    host, inside = ranges(t["cpu"], t["window"], lambda n: n.startswith(PREFIX))
    if not host:
        return None
    stalls, _ = ranges(t["cpu"], t["window"], lambda n: n in STALLS)
    busy = union([{"start": s, "end": e} for s, e in t["merged"] + stalls], t["window"])[0]
    idle = inside - overlap(host, busy)
    return 100.0 * idle * 1e-6 / t["window_s"]
