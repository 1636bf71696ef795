"""device_busy_share: the union of the device's kernels and of its copies
between device memory and pinned host memory over the traced window, in
percent.  Copies to or from pageable host memory are left out: the host paces
them (page faults, its own memcpy), so they say nothing of the device."""

from portbench.trace import union


def read(rec):
    t = rec.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    _, busy = union([d for d in t["device"] if not d["pageable"]], t["window"])
    return 100.0 * busy * 1e-6 / t["window_s"] if busy > 0 else None
