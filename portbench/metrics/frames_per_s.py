"""frames_per_s: output frames completed inside the window over the window's
seconds (host clock).  Resident: frames of the batches whose completion the
host saw inside the window; streamed: frames the sink received inside it."""


def read(rec):
    if not rec["batches"]:
        return None
    return sum(b["frames"] for b in rec["batches"]) / rec["window_s"]
