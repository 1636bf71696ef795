"""The readers of the program's own ranges, ``op_host_ms`` and
``dispatch_idle_share``: on made-up slices (nested ranges, idle gaps inside
and outside the program's ranges, no trace), on a real CPU profile of the
program, and in traced runs of the tiny cells on the CPU, where they are read
or left out, never 0."""

from __future__ import annotations

import json
import time

import pytest
import torch

from portbench import harness, spec
from portbench import trace as ptrace

from .conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
READERS = ("op_host_ms", "dispatch_idle_share")
SEED = 2**31 + 23


def _read(name, rec):
    return spec.load_file(REPO, "metrics", name).read(rec)


def _rec(cpu, merged, window=(0.0, 200.0)):
    return {"trace": {"calls": 2, "device": [], "ops": [], "cpu": cpu, "merged": merged,
                      "window": window, "window_s": (window[1] - window[0]) * 1e-6,
                      "busy_s": sum(e - s for s, e in merged) * 1e-6}}


# two op calls in a 200-us slice, in microseconds: the first with its
# derivation, a plane and its kernel wrapper inside; the device runs 30-120
CALLS = [("portbench.op", 5.0, 95.0), ("vszip.op.boxblur", 10.0, 90.0),
         ("vszip.op.boxblur.derive", 12.0, 20.0), ("vszip.op.boxblur.plane", 20.0, 50.0),
         ("vszip.kernel.ct_blur_int", 22.0, 48.0), ("aten::empty", 23.0, 24.0),
         ("portbench.op", 105.0, 155.0), ("vszip.op.boxblur", 110.0, 150.0),
         ("portbench.wait", 160.0, 200.0)]
BUSY = [[30.0, 120.0]]


def test_op_host_ms_is_the_median_of_the_outermost_op_ranges():
    assert _read("op_host_ms", _rec(CALLS, BUSY)) == pytest.approx((80.0 + 40.0) / 2 * 1e-3)
    # an op called by a stage of process_stream is a call, an op inside
    # another op is not: 80, 40 and 37 us give 40 (without the 37, 60; with
    # the limiter's 10, 38.5)
    nested = CALLS + [("vszip.stream.op", 160.0, 199.0), ("vszip.op.boxblur", 161.0, 198.0),
                      ("vszip.op.limiter", 170.0, 180.0)]
    assert _read("op_host_ms", _rec(nested, BUSY)) == pytest.approx(40.0 * 1e-3)


def test_op_host_ms_leaves_out_calls_cut_by_the_slice():
    cut = CALLS + [("vszip.op.boxblur", 190.0, 260.0), ("vszip.op.boxblur", -30.0, 2.0)]
    assert _read("op_host_ms", _rec(cut, BUSY)) == pytest.approx(60.0 * 1e-3)


def test_dispatch_idle_share_counts_idle_time_inside_the_programs_ranges_only():
    # host in vszip. ranges 10-90 and 110-150 (120 us); device busy 30-120:
    # idle inside them 10-30 and 120-150 (50 us of 200); the idle 150-200
    # under portbench.wait and 0-10 under no range are not the program's
    assert _read("dispatch_idle_share", _rec(CALLS, BUSY)) == pytest.approx(25.0)
    assert _read("dispatch_idle_share", _rec(CALLS, [[0.0, 200.0]])) == pytest.approx(0.0)
    # ranges that cross the slice's edges count inside it alone
    edge = [("vszip.op.boxblur", -50.0, 20.0), ("vszip.op.boxblur", 190.0, 300.0)]
    assert _read("dispatch_idle_share", _rec(edge, [])) == pytest.approx(15.0)


def test_the_profilers_own_stalls_are_not_the_programs_time():
    # inside the first call: a buffer request 12-18 while the device idles,
    # a full launch queue 40-60 while it runs (a wait for the device); the
    # second call's 20 us stall while idle, 125-145
    stalls = [("Activity Buffer Request", 12.0, 18.0), ("Command Buffer Full", 40.0, 60.0),
              ("cudaLaunchKernel", 120.0, 146.0), ("Command Buffer Full", 125.0, 145.0)]
    rec = _rec(CALLS + stalls, BUSY)
    # host time: 80 - 26 and 40 - 20
    assert _read("op_host_ms", rec) == pytest.approx((54.0 + 20.0) / 2 * 1e-3)
    # idle inside the program's ranges: 10-12, 18-30, 120-125 and 145-150
    assert _read("dispatch_idle_share", rec) == pytest.approx(12.0)


def test_the_readers_leave_a_slice_without_the_programs_ranges_out():
    no_program = [c for c in CALLS if not c[0].startswith("vszip.")]
    for name in READERS:
        assert _read(name, {"trace": None}) is None
        assert _read(name, {}) is None
        assert _read(name, _rec(no_program, BUSY)) is None
        missing = {"trace": {"calls": 0, "device": [], "ops": [], "cpu": [], "window_s": 0.0,
                             "busy_s": 0.0}}
        assert _read(name, missing) is None


def test_the_readers_read_a_real_profile_of_the_program():
    """The harness's own record of a CPU profile of three BoxBlur calls: the
    host is inside them, and the CPU runs no device work, so the idle share is
    the program's whole share of the slice."""
    import numpy as np

    import vszip_tpu_torch as vt

    rng = np.random.default_rng(1)
    planes = tuple(rng.integers(0, 65536, (2, h, w), dtype=np.uint16)
                   for h, w in ((64, 96), (32, 48), (32, 48)))
    clip = vt.Clip.from_planes(planes, vt.get_format("YUV420P16"), device="cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("portbench.traced"):
            for _ in range(3):
                with torch.profiler.record_function("portbench.op"):
                    vt.boxblur(clip, hradius=13, vradius=13)
    rec = ptrace._records(prof, 3)
    ops = [(s, e) for n, s, e in rec["cpu"] if n == "vszip.op.boxblur"]
    assert len(ops) == 3 and rec["merged"] == []
    host_ms = _read("op_host_ms", {"trace": rec})
    assert host_ms == pytest.approx(sorted(e - s for s, e in ops)[1] * 1e-3)
    share = _read("dispatch_idle_share", {"trace": rec})
    assert 0.0 < share <= 100.0
    assert share == pytest.approx(100.0 * sum(e - s for s, e in ops) * 1e-6 / rec["window_s"])


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_tiny_run_reads_the_metrics_or_leaves_them_out(tiny_root, cell):
    r = harness.run_cell(tiny_root, cell, SEED, 3.0, True, time.perf_counter(), device="cpu")
    assert r["correct"], r["checks"]
    for name in READERS:
        assert name not in r["metrics"] or r["metrics"][name]["value"] > 0, r["metrics"]
