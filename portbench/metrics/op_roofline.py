"""op_roofline: the op's least time over the device time of every kernel its
calls launched in the traced window, in percent.  The least time is the
larger of the bytes bound and the operations bound of one batch
(``traffic/cost.py``, with the op's own count in ``reference/<op>.py``) times
the calls traced."""


def read(rec):
    t = rec.get("trace")
    if not t or not t["calls"]:
        return None
    busy = sum(d["end"] - d["start"] for d in t["device"] if not d["copy"]) * 1e-6
    if busy <= 0:
        return None
    return 100.0 * rec["cost"]["least_ms"] * 1e-3 * t["calls"] / busy
