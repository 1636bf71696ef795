"""One run of one cell: set-up, the measured window, the check, the result.

``run_cell`` is the whole of a run after the command line: ``run.py`` calls it
on the card; the tests call it on the CPU at tiny sizes, where it drives the
program's CPU path with the same code.

Two drivers, chosen by the traffic mix's ``mode``:

* ``resident``: a closed loop of one client over a pool of frames made on the
  device.  Batch i is frames (i mod batches-in-pool) * batch ...; the client
  issues a batch's op call when fewer than ``in_flight`` are outstanding, and
  waits for the oldest one's completion event otherwise.
* ``streamed``: ``process_stream`` over a source that cycles a pool of frames
  in host memory (made on the device from the seed and copied down once in
  set-up), with a sink that takes every chunk's planes on the host, as an
  encoder would.  The sink ends the stream at the end of the window.

Both warm up every shape the window uses (``warmup`` batches, or chunks, of
the mix), then measure for ``seconds``.  Batches that complete after the
window are neither counted nor compared.

A metric op's configuration (one with ``compare``, see ``check.py``) also
names ``distorted``: the resident driver then makes a second pool from the
first in set-up (``frames.distort``, index for index), calls the op on the
two clips' batches, and samples the named frame props of completed batches
instead of their planes.  A configuration with ``"range": "limited"`` has its
pools made in the limited range.
"""

from __future__ import annotations

import collections
import random
import statistics
import time
from pathlib import Path

import torch

from . import check, imports, spec
from .trace import Tracer, breakdown
from .traffic import frames
from .traffic.cost import least_ms

STREAM_CHUNKS_PER_S = 20000  # an upper bound: the stream is sized to outlast the window


class WindowClosed(Exception):
    """Raised by the streamed cell's sink to end the stream at the window's end."""


class _HostEvent:
    """A CUDA event's interface, for runs on the CPU: work there is done when
    its call returns."""

    def record(self, stream=None):
        pass

    def synchronize(self):
        pass


class Reservoir:
    """A uniform sample of `k` of the offered items, drawn with `rng`."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng, self.items, self.seen = k, rng, [], 0

    def offer(self, key, value) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append((key, value))
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = (key, value)


class Cell:
    """What a run of one cell holds: its description, device and pool."""

    def __init__(self, root: Path, workload: str, seed: int, seconds: float, device: str):
        self.bench = spec.load(root)
        _, self.cfg, self.mix = spec.cell(root, self.bench, workload)
        self.seed = seed
        self.seconds = seconds
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.reference = spec.load_file(root, "reference", self.cfg["reference"])
        self.shapes = [tuple(s) for s in self.cfg["planes"]]
        self.batch = self.mix["batch"]
        self.metric = "compare" in self.cfg
        self.limited = self.cfg.get("range") == "limited"
        if self.metric and self.mix["mode"] != "resident":
            raise spec.SpecError(f"{workload}: a metric op runs in the resident mode only")

    def event(self):
        return torch.cuda.Event() if self.cuda else _HostEvent()

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def pool(self) -> tuple:
        return frames.make_planes(self.seed, self.mix["pool"], self.shapes, self.cfg["bits"],
                                  self.device, limited=self.limited)

    def pools(self) -> tuple:
        """The op's input pools: the source pool, and for a metric op the
        distorted one made from it."""
        pool = self.pool()
        if not self.metric:
            return (pool,)
        return pool, frames.distort(self.seed, pool, self.cfg["bits"], self.cfg["distorted"],
                                    self.limited)

    def sampled(self, out):
        """What the check compares of an op's output: its planes, or a
        metric op's named props (None where one is missing)."""
        if not self.metric:
            return out.planes
        return tuple(out.props.get(name) for name in self.cfg["compare"]["props"])

    def batch_frames(self, pool: tuple, index: int) -> tuple:
        k = (index % (self.mix["pool"] // self.batch)) * self.batch
        return tuple(p[k:k + self.batch] for p in pool)


def _program_op(vt, cfg: dict):
    fn = getattr(vt, cfg["op"])
    args = dict(cfg["args"])
    return lambda *clips: fn(*clips, **args)


def _resident(cell: Cell, vt, op, tracer: Tracer, sample: Reservoir) -> dict:
    fmt = vt.get_format(cell.cfg["format"])
    pools = cell.pools()
    cell.sync()
    t_pool = time.perf_counter()
    depth = cell.mix["in_flight"]

    def clips(i):
        return tuple(vt.Clip(cell.batch_frames(pool, i), fmt, {}) for pool in pools)

    # warm-up: `warmup` batches alive at once, so that the allocator holds
    # what the window keeps alive (the sample and the batches in flight)
    held = [op(*clips(i)) for i in range(cell.mix["warmup"])]
    tracer.warm(lambda: op(*clips(0)))
    cell.sync()
    del held
    if cell.cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    t_end = t0 + cell.seconds
    tracer.begin(t0, cell.seconds)
    inflight = collections.deque()
    batches, issued = [], 0
    while True:
        now = time.perf_counter()
        tracer.tick(now)
        if now >= t_end:
            break
        c = clips(issued)
        ended = cell.event()
        t_issue = time.perf_counter()
        with tracer.span("portbench.op"):
            out = op(*c)
        ended.record()
        tracer.called()
        inflight.append((issued, t_issue, ended, out))
        issued += 1
        del c, out
        if len(inflight) >= depth:
            i, ti, e, o = inflight.popleft()
            with tracer.span("portbench.wait"):
                e.synchronize()
            td = time.perf_counter()
            if td <= t_end:
                batches.append({"start": ti, "done": td, "frames": cell.batch})
                sample.offer(i, cell.sampled(o))
            del o
    cell.sync()
    tracer.finish()
    return {"t_pool": t_pool, "t0": t0, "batches": batches, "attempted": issued, "pool": pools,
            "stream": None}


def _streamed(cell: Cell, vt, op, tracer: Tracer, sample: Reservoir) -> dict:
    from vszip_tpu_torch.runtime import stream as rt

    fmt = vt.get_format(cell.cfg["format"])
    pool_frames = cell.mix["pool"]
    host = tuple(p.cpu().numpy() for p in cell.pool())
    t_pool = time.perf_counter()
    handed = {}

    def make(start, stop):
        k = start % pool_frames
        with tracer.span("portbench.source"):
            planes = tuple(p[k:k + stop - start] for p in host)
        handed[start] = time.perf_counter()
        return planes

    calls = [0]

    def traced_op(clip):
        calls[0] += 1
        tracer.called()
        with tracer.span("portbench.op"):
            return op(clip)

    batches, order = [], []
    window = {"end": None}

    def sink(start, clip):
        now = time.perf_counter()
        if window["end"] is None:
            return
        if now > window["end"]:
            raise WindowClosed
        with tracer.span("portbench.sink"):
            batches.append({"start": handed.pop(start), "done": now,
                            "frames": clip.planes[0].shape[0]})
            order.append(start)
            sample.offer(start // cell.batch, clip.planes)
        tracer.tick(now)

    batch = cell.batch
    device = cell.device.type
    warm_chunks = cell.mix["warmup"]
    vt.process_stream(vt.SyntheticSource(make, fmt, warm_chunks * batch), op, batch=batch,
                      sink=sink, device=device)
    tracer.warm(lambda: vt.process_stream(vt.SyntheticSource(make, fmt, batch), op,
                                          batch=batch, sink=sink, device=device))
    cell.sync()
    handed.clear()
    if cell.cuda:
        torch.cuda.reset_peak_memory_stats()
    chunks = int(STREAM_CHUNKS_PER_S * cell.seconds) + 4
    t0 = time.perf_counter()
    window["end"] = t0 + cell.seconds
    tracer.begin(t0, cell.seconds)
    try:
        vt.process_stream(vt.SyntheticSource(make, fmt, chunks * batch), traced_op,
                          batch=batch, sink=sink, device=device)
    except WindowClosed:
        pass
    else:
        raise RuntimeError("the stream ended before the window closed")
    cell.sync()
    tracer.finish()
    stats = rt.STATS
    missing = sum(1 for i, s in enumerate(order) if s != i * batch)
    return {"t_pool": t_pool, "t0": t0, "batches": batches, "attempted": calls[0],
            "pool": None, "missing": missing,
            "stream": {"fill_s": stats["fill_s"], "loaded": len(stats["copies"]),
                       "h2d_bytes": stats["h2d_bytes"],
                       "copy_ms": [b.elapsed_time(e) for b, e in stats["copies"]]}}


DRIVERS = {"resident": _resident, "streamed": _streamed}


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", wrap=None) -> dict:
    """One run of cell `workload`; returns the result's JSON object.  `wrap`,
    when given, is called as wrap(op, cell) and its return value replaces
    the program's op (the control and the planted faults)."""
    t_program = time.perf_counter()
    import vszip_tpu_torch as vt

    t_import = time.perf_counter()
    cell = Cell(root, workload, seed, seconds, device)
    op = _program_op(vt, cell.cfg)
    if wrap is not None:
        op = wrap(op, cell)
    tracer = Tracer(trace, cell.device, seconds=cell.mix["trace_seconds"])
    sample = Reservoir(cell.mix["sample"], random.Random(f"{seed}:sample"))
    imports.refuse("during set-up")

    run = DRIVERS[cell.mix["mode"]](cell, vt, op, tracer, sample)
    setup_s = run["t0"] - t_start
    peak = torch.cuda.max_memory_allocated() if cell.cuda else 0

    # the check: the program's state goes, the inputs are made again
    t_check = time.perf_counter()
    items = sample.items
    del run["pool"], sample
    if cell.metric:
        pools = cell.pools() if items else ()
        results = [check.compare_props(cell.reference, cell.cfg,
                                       tuple(cell.batch_frames(p, i) for p in pools), out,
                                       cell.device) for i, out in items]
        del pools
    else:
        pool = cell.pool() if items else None
        results = [check.compare(cell.reference, cell.cfg, cell.batch_frames(pool, i), out,
                                 cell.device) for i, out in items]
        del pool
    del items
    extra = {}
    if "missing" in run:
        extra["chunks_out_of_order"] = {"value": run["missing"], "limit": 0}
    cell.sync()
    t_checked = time.perf_counter()
    checks = check.numbers(results, cell.cfg["limits"], extra)
    correct = check.passed(checks)

    nbytes, int_ops, f32_ops = cell.reference.work(cell.cfg, cell.batch)
    least, bound_by = least_ms(nbytes, int_ops, f32_ops)
    # the work of the op's stages that a reference module counts on its own
    stages = getattr(cell.reference, "stage_work", None)
    rec = {"window_s": cell.seconds, "setup_s": setup_s, "batches": run["batches"],
           "stream": run["stream"], "trace": tracer.kept,
           "cost": {"bytes": nbytes, "int_ops": int_ops, "f32_ops": f32_ops,
                    "least_ms": least, "bound_by": bound_by,
                    "stages": stages(cell.cfg, cell.batch) if stages else {}}}
    metrics = {}
    for m in spec.metrics(cell.bench, workload, trace):
        value = spec.load_file(root, "metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cell.cuda else "cpu",
           "kind": torch.cuda.get_device_name(cell.device) if cell.cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": run["attempted"],
              "failed": sum(1 for r in results
                            if not check.passed(check.numbers([r], cell.cfg["limits"])))
                        + run.get("missing", 0),
              "metrics": metrics, "device": dev}
    if trace:
        t = rec["trace"]
        dev["busy_s"] = t["busy_s"] if t else 0.0
        dev["window_s"] = t["window_s"] if t else 0.0
        if t:
            result["breakdown"] = breakdown(t)
        result["bound"] = {"least_ms_per_batch": least, "by": bound_by}
        result["trace_slices"] = tracer.notes
    values = [v for r in results for v in r.get("values", [])]
    if values:
        result["sampled_value_median"] = statistics.median(values)
    result["setup"] = {"torch_s": t_program - t_start, "program_import_s": t_import - t_program,
                       "frames_s": run["t_pool"] - t_import,
                       "warmup_s": run["t0"] - run["t_pool"], "check_s": t_checked - t_check}
    result["checks"] = checks
    # last, once the reference and every metric's reader have been loaded
    imports.refuse("by the end of the run")
    return result
