"""stream_h2d_gbps: the rate of the streaming runtime's host-to-device copies,
``STATS["h2d_bytes"]`` over the summed CUDA-event time of its copies, in 1e9
bytes a second."""


def read(rec):
    s = rec.get("stream")
    if not s or not s["copy_ms"]:
        return None
    return s["h2d_bytes"] / (sum(s["copy_ms"]) * 1e-3) / 1e9
