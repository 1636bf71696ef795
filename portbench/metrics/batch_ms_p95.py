"""batch_ms_p95: the 95th percentile (nearest rank) of every batch completed
in the window, by the host clock.  Resident: from the host issuing the batch's
op call to the host seeing its completion event; streamed: from the source
handing over the chunk's frames to the sink receiving its planes."""

import math


def read(rec):
    lat = sorted(b["done"] - b["start"] for b in rec["batches"])
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
