"""Time the streamed row's two ways of filling the pinned staging ring, in
turns, on one card.

Run from the checkout root on a machine with an NVIDIA GPU:

    python3 tools/stream_fill.py [pairs]

It streams 192 frames of 1080p YUV420P16, sliced from a 64-frame template
made by ``default_rng(0)`` as ``chip_smoke.py``'s ``boxblur_r13_streamed``
row does, through ``boxblur(r=13)`` in chunks of 64 with no sink, once with
the package's fill (``Tensor.copy_``, torch's multi-threaded copy) and once
with a single-threaded ``np.copyto`` patched in for
``vszip_tpu_torch.runtime.stream._fill``, in `pairs` pairs (default 10),
alternating which goes first.  Per run: the wall time of the synchronized
call, the host time filling the ring, the copies' and the chunks' device
time (CUDA events in ``stream.STATS``).  Prints each run, then per method
the median and quartiles of each, and how many pairs each method won on
wall time.
"""

import sys
import time
from pathlib import Path

import numpy as np
import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("stream_fill: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import vszip_tpu_torch as vt
    from vszip_tpu_torch.runtime import stream as rs

    pairs = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    fmt = vt.get_format("YUV420P16")
    rng = np.random.default_rng(0)
    template = tuple(rng.integers(0, 1 << 16, (64,) + fmt.plane_dims(1920, 1080, p)[::-1],
                                  dtype=np.uint16) for p in range(3))
    source = vt.SyntheticSource(lambda a, b: tuple(p[: b - a] for p in template), fmt, 192)

    def numpy_fill(view, p):
        np.copyto(view.numpy(), p, casting="no")

    methods = {"copy_": rs._fill, "np.copyto": numpy_fill}

    def run(name):
        rs._fill = methods[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vt.process_stream(source, lambda c: vt.boxblur(c, hradius=13, vradius=13), batch=64)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        rs._fill = methods["copy_"]
        return (wall, rs.STATS["fill_s"] * 1e3,
                sum(a.elapsed_time(b) for a, b in rs.STATS["copies"]),
                sum(a.elapsed_time(b) for a, b in rs.STATS["computes"]))

    for name in methods:  # warm-up
        run(name)
    results = {name: [] for name in methods}
    wins = {name: 0 for name in methods}
    card = torch.cuda.get_device_name(0)
    print(f"{card}; torch {torch.__version__}, {torch.get_num_threads()} CPU threads")
    for i in range(pairs):
        order = list(methods) if i % 2 == 0 else list(methods)[::-1]
        got = {name: run(name) for name in order}
        for name in order:
            results[name].append(got[name])
            print(f"pair {i + 1} {name}: wall {got[name][0]:.3f} ms, fill {got[name][1]:.3f} ms, "
                  f"copies {got[name][2]:.3f} ms, compute {got[name][3]:.3f} ms")
        a, b = (got[n][0] for n in methods)
        if a != b:
            wins[list(methods)[0 if a < b else 1]] += 1
    for name, rows in results.items():
        cols = np.array(rows)
        q = np.percentile(cols, [25, 50, 75], axis=0)
        print(f"{name}: " + "; ".join(
            f"{what} median {q[1][k]:.3f} ms (quartiles {q[0][k]:.3f}-{q[2][k]:.3f})"
            for k, what in enumerate(("wall", "fill", "copies", "compute")))
            + f"; {192 / (q[1][0] * 1e-3):.1f} frames/s at the median wall; won {wins[name]} "
            f"of {pairs} pairs [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
