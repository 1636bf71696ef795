"""The least time one batch of an op could take on one H100: the yardstick of
``op_roofline``.

A batch's least time is the larger of two bounds, each counted from the work
the published function needs, never from how a kernel is built:

* bytes: each input plane read once and each output plane written once, over
  the memory rate (``plane_bytes``);
* operations: the arithmetic the published formula needs per output sample,
  each counted once, over the pipe's peak rate.  Each op's reference module
  counts its own (``work`` in ``reference/<op>.py``).

The peaks are NVIDIA's data sheet for the H100 SXM part: 3.35 TB/s of HBM3
and 67 TFLOP/s of float32 outside the tensor cores (an FMA counts as two
operations).  Integer operations run at 64 per SM per clock (the CUDA C++
Programming Guide's throughput table for compute capability 9.0), 132 SMs at
1.98 GHz.

Taken from ``chip_smoke.py``'s ``cost`` and its peaks: ``PEAK_BYTES``,
``PEAK_INT_OPS`` and the byte count (each input read once, each output
written once).  Not taken: its operation counts, which count instructions as
a kernel issues them (fused multiply-adds, 3-input adds) and so follow a
kernel's design.
"""

from __future__ import annotations

PEAK_BYTES = 3.35e12
PEAK_INT_OPS = 64 * 132 * 1.98e9
PEAK_F32 = 67e12


def plane_bytes(shapes, frames: int, bytes_per_sample: int) -> int:
    """Bytes of a batch that reads planes of the (height, width) `shapes` once
    and writes planes of the same shapes once."""
    return 2 * frames * bytes_per_sample * sum(h * w for h, w in shapes)


def least_ms(nbytes: int, int_ops: int, f32_ops: int) -> tuple[float, str]:
    """The least milliseconds and which bound sets it ("bytes" or
    "operations")."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = int_ops / PEAK_INT_OPS + f32_ops / PEAK_F32
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"
