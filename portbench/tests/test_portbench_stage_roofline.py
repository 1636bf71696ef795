"""The 5-pass BoxBlur cell's own pieces: the runtime-path reference's work
count and its split by axis, the two stage metrics on made-up slices (this
machine has no card to trace), and a traced tiny run of the cell on the CPU,
where the stage metrics find nothing to read."""

from __future__ import annotations

import json
import time

import pytest

from portbench import harness, spec
from portbench.traffic.cost import least_ms

from .conftest import REPO

CELL = "boxblur_r13_5pass.resident"
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CFG = spec.cell(REPO, BENCH, CELL)[1]
REF = spec.load_file(REPO, "reference", CFG["reference"])
H = spec.load_file(REPO, "metrics", "h_stage_roofline")
V = spec.load_file(REPO, "metrics", "v_stage_roofline")
NAMES = {
    "h": "void (anonymous namespace)::h_fixed_kernel<unsigned short, false>("
         "unsigned short const*, unsigned short*, long long, int, int, int)",
    "v": "void (anonymous namespace)::v_chip_kernel<unsigned short, 5, true>("
         "unsigned short const*, unsigned short*, int, int, int, int, long long, unsigned int)",
    "walk": "void (anonymous namespace)::v_fixed_kernel<unsigned short>(unsigned short const*)",
    "ct": "void (anonymous namespace)::ct_v_chip_kernel<unsigned short, true>("
          "unsigned short const*, unsigned short*, int, int, int, int, unsigned int, int)",
    "copy": "Memcpy DtoD (Device -> Device)",
}


def _rec(kernels, calls=2, frames=64):
    """A record as the harness builds it: the op's cost from the reference,
    and a slice of `kernels`, (name key, microseconds) in turn."""
    nbytes, int_ops, f32_ops = REF.work(CFG, frames)
    least, by = least_ms(nbytes, int_ops, f32_ops)
    device, t = [], 0.0
    for key, us in kernels:
        device.append({"name": NAMES[key], "start": t, "end": t + us, "copy": key == "copy",
                       "pageable": False})
        t += us + 5.0
    return {"trace": {"calls": calls, "device": device},
            "cost": {"bytes": nbytes, "int_ops": int_ops, "f32_ops": f32_ops,
                     "least_ms": least, "bound_by": by}}


def test_work_counts_both_axes_and_splits_them_in_half():
    nbytes, int_ops, f32_ops = REF.work(CFG, 64)
    axes = REF.work_by_axis(CFG, 64)
    assert set(axes) == {"h", "v"}
    assert nbytes == 2 * 2 * 64 * (1920 * 1080 + 2 * 960 * 540) == 796_262_400
    assert int_ops == 6 * 10 * 64 * 3_110_400 == 11_943_936_000 and f32_ops == 0
    assert sum(a[1] for a in axes.values()) == int_ops
    for a in axes.values():
        assert a == (nbytes, int_ops * H.AXIS_SHARE, 0)
    # the op and each stage are bound by operations at these counts
    assert least_ms(nbytes, int_ops, 0)[1] == "operations"
    assert least_ms(*axes["h"])[1] == "operations"


def test_the_stage_metrics_read_the_split_the_reference_gives():
    h_us, v_us = 2473.0, 643.0
    rec = _rec([("h", h_us / 3), ("v", v_us / 3), ("ct", 500.0), ("copy", 900.0)] * 3 * 2)
    axes = REF.work_by_axis(CFG, 64)
    for metric, axis, us in ((H, "h", h_us), (V, "v", v_us)):
        want = 100.0 * least_ms(*axes[axis])[0] * 1e-3 * 2 / (us * 2 * 1e-6)
        assert metric.read(rec) == pytest.approx(want, rel=1e-12)
        assert 0 < metric.read(rec) < 100
    assert H.read(rec) == pytest.approx(14.43, abs=0.01)
    assert V.read(rec) == pytest.approx(55.5, abs=0.1)


def test_the_vertical_metric_takes_the_column_walk_and_never_b1s_vertical_stage():
    only_b1 = _rec([("ct", 300.0), ("h", 500.0)])
    assert V.read(only_b1) is None and H.read(only_b1) is not None
    walk = _rec([("walk", 1000.0), ("ct", 300.0)])
    assert V.read(walk) == pytest.approx(V.read(_rec([("v", 1000.0)])))


@pytest.mark.parametrize("trace", [None, {"calls": 0, "device": []},
                                   {"calls": 3, "device": []}],
                         ids=["missing", "no_calls", "no_kernels"])
def test_both_metrics_are_absent_where_there_is_nothing_to_read(trace):
    rec = _rec([])
    rec["trace"] = trace
    assert H.read(rec) is None and V.read(rec) is None


def test_a_traced_tiny_run_of_the_cell_leaves_the_stage_metrics_out_on_the_cpu(tiny_root):
    r = harness.run_cell(tiny_root, CELL, 2**31 + 23, 1.5, True, time.perf_counter(),
                         device="cpu")
    assert r["correct"], r["checks"]
    assert "h_stage_roofline" not in r["metrics"] and "v_stage_roofline" not in r["metrics"]
    assert r["bound"]["by"] == "operations"
