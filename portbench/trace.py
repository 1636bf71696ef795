"""The traced slice of a ``--trace 1`` run, and what is read from it.

The drivers call ``tick`` at every batch boundary and ``called`` at every op
call.  From the first tick at or after ``start_at`` the tracer waits for the
device to go idle, starts ``torch.profiler`` (CPU and CUDA activities) and
marks the slice with a ``portbench.traced`` range; ``seconds`` later it waits
for the device again and stops.  So the slice holds every kernel of the op
calls issued inside it and no other.

On the H100 the profiler has returned traces with no device activity and
traces short by 5-16% of the device time with every kernel in them, and
loses kernels of some slices (2 of 10,560 in a cell of 6 kernels a call; at
some 35,000 kernels a second, 0.05-58% of a slice's in 17 of 26 slices).  So
slices are taken back to back from ``LEAD`` of the window on, up to
``TRIES`` or the window's end (a slice that the window's close cuts short is
read only when it is the first), and of those whose device time per call
lies within ``TOL`` of the slices' median, the fullest (most kernels per
call; the first of equals) is kept: of all of them where none does.  Only
when no slice holds a kernel is the trace reported missing, and the metrics
that read it are left out of the result: never read as 0.
"""

from __future__ import annotations

import contextlib
import statistics
import time

import numpy as np
import torch

TRIES = 8
LEAD = 0.2      # share of the window before the first slice starts
TOL = 0.02
COPIES = ("Memcpy HtoD", "Memcpy DtoH")
PAGEABLE = "Pageable"   # in the name of a copy to or from pageable host memory
OP_RANGE = "portbench.op"
TOP = 10
GAPS = 200


class Tracer:
    def __init__(self, enabled: bool, device: torch.device, start_at: float = 0.0,
                 seconds: float = 0.0):
        self.enabled = enabled
        self.cuda = device.type == "cuda"
        self.start_at = start_at
        self.seconds = seconds
        self.prof = None
        self.calls = 0
        self.t0 = 0.0
        self.tries = 0
        self.slices = []          # (records, (kernels, device us) per call) with kernels
        self.kept = None          # the kept slice's records, once the window has closed
        self.done = not enabled
        self.notes = []           # per slice: what it held, for standard error

    def span(self, name: str):
        """A named CPU range in the trace while a slice runs."""
        if self.prof is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def warm(self, fn) -> None:
        """Run `fn` once under the profiler, so that its first start (CUPTI's
        set-up) falls in set-up and not in the window."""
        if not self.enabled:
            return
        with torch.profiler.profile(activities=self._activities()):
            fn()
            self._sync()

    def _activities(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def begin(self, t0: float, seconds: float) -> None:
        """Set the first slice's start for a window of `seconds` from `t0`."""
        self.start_at = t0 + LEAD * seconds

    def called(self) -> None:
        if self.prof is not None:
            self.calls += 1

    def tick(self, now: float) -> None:
        if self.done:
            return
        if self.prof is None and now >= self.start_at:
            self._sync()
            self.prof = torch.profiler.profile(activities=self._activities())
            self.prof.start()
            self.mark = torch.profiler.record_function("portbench.traced")
            self.mark.__enter__()
            self.calls = 0
            self.t0 = time.perf_counter()
        elif self.prof is not None and now >= self.t0 + self.seconds:
            self._stop()

    def finish(self) -> None:
        """End a slice still running when the window closes."""
        if self.prof is not None:
            self._stop(cut=True)
        self.kept = _kept(self.slices)
        self.done = True

    def _stop(self, cut: bool = False) -> None:
        self._sync()
        self.mark.__exit__(None, None, None)
        t_stop = time.perf_counter()
        self.prof.stop()
        t = time.perf_counter()
        prof, self.prof = self.prof, None
        if cut and self.slices:
            self.notes.append({"calls": self.calls, "cut": "by the window's close, not read"})
            return
        rec = _records(prof, self.calls)
        names = {}
        for d in rec["device"]:
            names[d["name"][:48]] = names.get(d["name"][:48], 0) + 1
        self.notes.append({"calls": rec["calls"], "device": len(rec["device"]),
                           "window_s": rec["window_s"], "busy_s": rec["busy_s"],
                           "stop_s": t - t_stop, "read_s": time.perf_counter() - t,
                           "names": sorted(names.items(), key=lambda kv: -kv[1])[:8]})
        kernels = [d for d in rec["device"] if not d["copy"]]
        if rec["calls"] and kernels:
            per_call = (len(kernels) / rec["calls"],
                        sum(d["end"] - d["start"] for d in kernels) / rec["calls"])
            self.notes[-1]["per_call"] = per_call
            self.slices.append((rec, per_call))
        self.tries += 1
        if self.tries >= TRIES:
            self.done = True


def _kept(slices: list):
    """Of the slices whose device time per call lies within TOL of their
    median (of all, where none does), the records of the one with the most
    kernels per call, the first of equals; None without a slice."""
    if not slices:
        return None
    mid = statistics.median(pc[1] for _, pc in slices)
    sound = [s for s in slices if abs(s[1][1] - mid) <= TOL * mid] or slices
    return max(sound, key=lambda s: s[1][0])[0]


def union(device: list, window: tuple) -> tuple[list, float]:
    """The merged intervals of `device` (dicts with ``start`` and ``end``)
    clipped to `window`, and their total length, in the clock's units."""
    spans = sorted((max(d["start"], window[0]), min(d["end"], window[1])) for d in device)
    merged = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged, sum(e - s for s, e in merged)


def _records(prof, calls: int) -> dict:
    """The slice's device intervals, the device spans of the op calls, CPU
    ranges, busy and window seconds, in microseconds of the profiler's clock."""
    device, ops, cpu, window = [], [], [], None
    cuda = torch.autograd.DeviceType.CUDA
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start = ev.start_ns() * 1e-3
        end = start + ev.duration_ns() * 1e-3
        if ev.device_type() == cuda:
            # a named CPU range also shows on the device's timeline (a GPU
            # user annotation, from its first kernel's start to its last's
            # end): it is no device work, and gives an op call's device span
            if ev.is_user_annotation():
                if name == OP_RANGE:
                    ops.append((start, end))
            else:
                device.append({"name": name, "start": start, "end": end,
                               "copy": name.startswith(COPIES),
                               "pageable": name.startswith(COPIES) and PAGEABLE in name})
        elif name == "portbench.traced":
            window = (start, end)
        else:
            cpu.append((name, start, end))
    if window is None:
        return {"calls": 0, "device": [], "ops": [], "cpu": [], "window_s": 0.0, "busy_s": 0.0}
    device = [d for d in device if d["end"] > window[0] and d["start"] < window[1]]
    ops = [o for o in ops if o[1] > window[0] and o[0] < window[1]]
    merged, busy = union(device, window)
    return {"calls": calls, "device": device, "ops": ops, "cpu": cpu, "merged": merged,
            "window": window, "window_s": (window[1] - window[0]) * 1e-6,
            "busy_s": busy * 1e-6}


def breakdown(rec: dict) -> dict:
    """The device operations that took most time, and the longest idle gaps
    by what the host was doing (the innermost CPU range over each gap's
    middle), each as [name, seconds], at most TOP of each."""
    ops = {}
    for d in rec["device"]:
        ops[d["name"]] = ops.get(d["name"], 0.0) + (d["end"] - d["start"]) * 1e-6
    w0, w1 = rec["window"]
    edges = [w0] + [v for s, e in rec["merged"] for v in (s, e)] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:GAPS]
    names = [c[0] for c in rec["cpu"]]
    starts = np.array([c[1] for c in rec["cpu"]], dtype=np.float64)
    ends = np.array([c[2] for c in rec["cpu"]], dtype=np.float64)
    idle = {}
    for s, e in gaps:
        mid = (s + e) / 2
        cover = np.nonzero((starts <= mid) & (ends >= mid))[0]
        name = (names[cover[np.argmax(starts[cover])]] if len(cover)
                else "host outside traced ranges")
        idle[name] = idle.get(name, 0.0) + (e - s) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"device_ops": top(ops), "idle_gaps": top(idle)}
