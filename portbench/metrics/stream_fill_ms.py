"""stream_fill_ms: host milliseconds the streaming runtime spent filling its
pinned staging buffers, per chunk (``STATS["fill_s"]`` over the chunks it
loaded)."""


def read(rec):
    s = rec.get("stream")
    if not s or not s["loaded"]:
        return None
    return s["fill_s"] / s["loaded"] * 1e3
