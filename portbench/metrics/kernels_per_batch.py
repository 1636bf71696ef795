"""kernels_per_batch: device kernels (memsets included, the runtime's
host-device copies not) the traced window ran, over the op calls issued in
it.  The trace starts and ends on an idle device, so every kernel of those
calls and no other is in it."""


def read(rec):
    t = rec.get("trace")
    if not t or not t["calls"]:
        return None
    kernels = [d for d in t["device"] if not d["copy"]]
    return len(kernels) / t["calls"] if kernels else None
