"""What the port's spans cost on the host, on one card.

Run from the checkout root on a machine with an NVIDIA GPU:

    python3 tools/span_cost.py [rounds]

Three modes, in turns, `rounds` times (default 5): tracing off, under
``trace.collect()`` and under a running ``torch.profiler`` (CPU and CUDA
activities, as the benchmark's traced slice).  Per mode it prints:

* the ns per span of ``with trace.span(...)`` and of a call of a
  ``trace.spanned`` function less a plain call (50,000 each a round);
* the host time of one call of BoxBlur r13 and of Bilateral s2r2 on 64
  frames of 1080p YUV420P16 made on the card (the benchmark's two
  configurations): from the call to its return, with the device idle
  before it, so the launch queue never holds the host back (median and
  95th percentile over 200 BoxBlur and 4 Bilateral calls a round);
* the spans one call of each opens, and after the rounds each span's self
  time per call (under ``collect()``, over as many calls as a round makes).

Ends with one JSON line of the medians over the rounds, the card's name and
its power limit.
"""

import json
import statistics
import subprocess
import sys
import time
from contextlib import nullcontext
from pathlib import Path

import torch

SPANS = 50_000
MODES = ("off", "collect", "profiler")


def _mode(name, trace):
    if name == "collect":
        return trace.collect()
    if name == "profiler":
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        return torch.profiler.profile(activities=acts)
    return nullcontext()


def _per_span_ns(trace) -> tuple[float, float]:
    span = trace.span

    def plain():
        return None

    spanned = trace.spanned("vszip.cost.fn")(plain)
    t0 = time.perf_counter_ns()
    for _ in range(SPANS):
        with span("vszip.cost"):
            pass
    t1 = time.perf_counter_ns()
    for _ in range(SPANS):
        spanned()
    t2 = time.perf_counter_ns()
    for _ in range(SPANS):
        plain()
    t3 = time.perf_counter_ns()
    return (t1 - t0) / SPANS, ((t2 - t1) - (t3 - t2)) / SPANS


def _host_ms(op, clip, calls) -> list:
    out = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        op(clip)
        out.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return out


def _p95(v):
    s = sorted(v)
    return s[-(-95 * len(s) // 100) - 1]


def main() -> int:
    if not torch.cuda.is_available():
        print("span_cost: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import vszip_tpu_torch as vt
    from vszip_tpu_torch import trace

    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    fmt = vt.get_format("YUV420P16")
    gen = torch.Generator(device="cuda").manual_seed(7)
    planes = tuple(torch.randint(0, 1 << 16, (64,) + fmt.plane_dims(1920, 1080, p)[::-1],
                                 generator=gen, device="cuda", dtype=torch.int32)
                   .to(torch.uint16) for p in range(3))
    clip = vt.Clip(planes, fmt, {})
    ops = {"boxblur": (lambda c: vt.boxblur(c, hradius=13, vradius=13), 200),
           "bilateral": (lambda c: vt.bilateral(c, sigmaS=2.0, sigmaR=2.0, planes=[0, 1, 2]), 4)}
    spans_per_call = {}
    for name, (op, _) in ops.items():
        op(clip)                                  # build and warm up
        torch.cuda.synchronize()
        with trace.collect() as t:
            op(clip)
        torch.cuda.synchronize()
        spans_per_call[name] = len(t.spans)
        print(f"{name}: {len(t.spans)} spans a call: "
              f"{ {k: v['count'] for k, v in t.totals().items()} }")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        _host_ms(ops["boxblur"][0], clip, 2)      # the profiler's first start

    readings = {m: {"span_ns": [], "spanned_ns": [], "boxblur_ms": [], "bilateral_ms": []}
                for m in MODES}
    for r in range(rounds):
        order = MODES if r % 2 == 0 else MODES[::-1]
        for m in order:
            with _mode(m, trace):
                span_ns, spanned_ns = _per_span_ns(trace)
                host = {n: _host_ms(op, clip, calls) for n, (op, calls) in ops.items()}
            rd = readings[m]
            rd["span_ns"].append(span_ns)
            rd["spanned_ns"].append(spanned_ns)
            for n, v in host.items():
                rd[f"{n}_ms"].extend(v)
            print(f"round {r} {m}: span {span_ns:.1f} ns, spanned call +{spanned_ns:.1f} ns, "
                  f"boxblur median {statistics.median(host['boxblur']):.4f} ms "
                  f"p95 {_p95(host['boxblur']):.4f}, bilateral median "
                  f"{statistics.median(host['bilateral']):.4f} ms", flush=True)
    self_ms = {}
    for name, (op, calls) in ops.items():
        with trace.collect() as t:
            _host_ms(op, clip, calls)
        self_ms[name] = {k: v["self_s"] * 1e3 / calls for k, v in t.totals().items()}
        print(f"{name}: self ms a call by span: {self_ms[name]}")
    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        card = "not read"
    summary = {"card": card, "torch": torch.__version__, "spans_per_call": spans_per_call,
               "self_ms_per_call": self_ms}
    for m, rd in readings.items():
        summary[m] = {"span_ns": statistics.median(rd["span_ns"]),
                      "spanned_ns": statistics.median(rd["spanned_ns"]),
                      "boxblur_ms": statistics.median(rd["boxblur_ms"]),
                      "boxblur_ms_p95": _p95(rd["boxblur_ms"]),
                      "bilateral_ms": statistics.median(rd["bilateral_ms"]),
                      "bilateral_ms_p95": _p95(rd["bilateral_ms"])}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
