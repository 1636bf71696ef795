"""op_device_ms: the median over the traced slice of the device span of one
op call (one batch): the profiler's device-side range of the call, from its
first kernel's start to its last kernel's end."""

import statistics


def read(rec):
    t = rec.get("trace")
    if not t or not t["ops"]:
        return None
    return statistics.median(e - s for s, e in t["ops"]) * 1e-3
