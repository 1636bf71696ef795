"""The SSIMULACRA2 cell's own pieces: the plain reference against the
program's CPU path on small limited-range YUV420P10 and RGB pairs, its
bfloat16 control, the limited-range pool and its distortion, the work
counts, and ``ssim_sums_roofline`` on made-up slices (this machine has no
card to trace)."""

from __future__ import annotations

import json
import time

import pytest
import torch

import vszip_tpu_torch as vt
from portbench import harness, spec
from portbench.traffic import frames
from portbench.traffic.cost import least_ms

from .conftest import REPO

CELL = "ssimulacra2.resident"
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CFG = spec.cell(REPO, BENCH, CELL)[1]
REF = spec.load_file(REPO, "reference", CFG["reference"])
METRIC = spec.load_file(REPO, "metrics", "ssim_sums_roofline")
CPU = torch.device("cpu")
YUV = [[64, 96], [32, 48], [32, 48]]
RGB = [[64, 96]] * 3
RTOL = 1e-3   # the metric's own tolerance on a score


def _pair(seed, shapes, limited, frames_=3):
    src = frames.make_planes(seed, frames_, shapes, 10, CPU, limited=limited)
    return src, frames.distort(seed, src, 10, CFG["distorted"], limited)


def _cases():
    yuv = {**CFG, "width": 96, "height": 64, "planes": YUV}
    rgb = {**CFG, "format": "RGB30", "family": "RGB", "subsampling": [0, 0],
           "width": 96, "height": 64, "planes": RGB, "range": "full"}
    return [("yuv420p10", yuv, YUV, True), ("rgb30", rgb, RGB, False)]


def _program(cfg, src, dist):
    fmt = vt.get_format(cfg["format"])
    out = vt.ssimulacra2(vt.Clip.from_planes(src, fmt, device="cpu"),
                         vt.Clip.from_planes(dist, fmt, device="cpu"))
    return out.props["SSIMULACRA2"]


@pytest.mark.parametrize("name,cfg,shapes,limited", _cases(), ids=[c[0] for c in _cases()])
@pytest.mark.parametrize("seed", [3, 2**31 + 7])
def test_reference_agrees_with_the_program_cpu_path(name, cfg, shapes, limited, seed):
    src, dist = _pair(seed, shapes, limited)
    want = REF.score(src, dist, cfg)["SSIMULACRA2"]
    got = _program(cfg, src, dist)
    assert want.dtype == torch.float64 and want.shape == (3,)
    assert torch.allclose(got, want, rtol=RTOL, atol=0.0)
    assert float((got - want).abs().max()) <= CFG["limits"]["max_abs_score"]
    assert all(0.0 < v < 100.0 for v in want.tolist())


@pytest.mark.parametrize("name,cfg,shapes,limited", _cases(), ids=[c[0] for c in _cases()])
def test_the_bfloat16_control_lands_outside_the_limit(name, cfg, shapes, limited):
    src, dist = _pair(11, shapes, limited)
    exact = REF.score(src, dist, cfg)["SSIMULACRA2"]
    low = REF.score(src, dist, cfg, control=True)["SSIMULACRA2"]
    assert float((exact - low).abs().max()) > CFG["limits"]["max_abs_score"]
    assert not torch.allclose(exact, low, rtol=RTOL, atol=0.0)


def test_identical_clips_score_100():
    """To float64's rounding: the SSIM map's two sides cancel to a few ulp."""
    src, _ = _pair(5, YUV, True, 2)
    cfg = {**CFG, "width": 96, "height": 64, "planes": YUV}
    assert REF.score(src, src, cfg)["SSIMULACRA2"].tolist() == pytest.approx([100.0] * 2,
                                                                             abs=1e-6)


def test_the_limited_pool_and_its_distortion_are_seeded_and_in_range():
    a, da = _pair(123, YUV, True)
    b, db = _pair(123, YUV, True)
    c, dc = _pair(124, YUV, True)
    assert all(torch.equal(x, y) for x, y in zip(a + da, b + db))
    assert not torch.equal(da[0], dc[0])
    for k, (p, d) in enumerate(zip(a, da)):
        lo, hi = frames.limited_span(10, k > 0)
        for x in (p, d):
            x = x.to(torch.int32)
            assert x.dtype == torch.int32 and int(x.min()) >= lo and int(x.max()) <= hi
        assert p.shape == d.shape and p.dtype == d.dtype == torch.uint16
        moved = (p.to(torch.int32) - d.to(torch.int32)).abs()
        assert 0 < int(moved.max()) <= 64
    # the 1080p luma of a limited pool reaches both ends of its range
    luma = frames.make_planes(2**31 + 9, 1, [(1080, 1920)], 10, CPU, limited=True)[0]
    assert (int(luma.to(torch.int32).min()), int(luma.to(torch.int32).max())) == (64, 940)
    # the full-range pool is what it was: limited=False changes nothing
    assert all(torch.equal(x, y) for x, y in zip(
        frames.make_planes(7, 2, YUV, 16, CPU), frames.make_planes(7, 2, YUV, 16, CPU, False)))


def test_work_counts_both_clips_and_the_kept_pairs():
    nbytes, int_ops, f32_ops = REF.work(CFG, 64)
    assert (nbytes, int_ops, f32_ops) == (796262400, 13004697600, 87988070400)
    stage = REF.stage_work(CFG, 64)["ssim_sums"]
    assert stage[1] == 0 and 0 < stage[2] < f32_ops
    kept = [(p, s) for s in range(6) for p in range(3) if any(REF.kept(p, s))]
    assert len(kept) == 11
    # both the op and B13 are bound by their operations at these counts
    assert least_ms(nbytes, int_ops, f32_ops)[1] == "operations"
    assert least_ms(*stage)[1] == "operations"


NAMES = {
    "b13": "void (anonymous namespace)::ssim_band_kernel<true, true, 2>(float const*, "
           "float const*, float*, int, int, int, int)",
    "b13_1": "void (anonymous namespace)::ssim_band_kernel<false, true, 1>(float const*, "
             "float const*, float*, int, int, int, int)",
    "torch": "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add"
             "<float>, std::array<char*, 3ul> >(int, at::native::CUDAFunctor_add<float>, "
             "std::array<char*, 3ul>)",
    "copy": "Memcpy DtoD (Device -> Device)",
}


def _rec(kernels, calls=2):
    device, t = [], 0.0
    for key, us in kernels:
        device.append({"name": NAMES[key], "start": t, "end": t + us, "copy": key == "copy",
                       "pageable": False})
        t += us + 5.0
    nbytes, int_ops, f32_ops = REF.work(CFG, 64)
    least, by = least_ms(nbytes, int_ops, f32_ops)
    return {"trace": {"calls": calls, "device": device},
            "cost": {"bytes": nbytes, "int_ops": int_ops, "f32_ops": f32_ops,
                     "least_ms": least, "bound_by": by, "stages": REF.stage_work(CFG, 64)}}


def test_ssim_sums_roofline_reads_b13_by_its_function_name():
    rec = _rec([("b13", 1500.0), ("b13_1", 500.0), ("torch", 9000.0), ("copy", 300.0)] * 2)
    least = least_ms(*REF.stage_work(CFG, 64)["ssim_sums"])[0]
    want = 100.0 * least * 1e-3 * 2 / (4000.0 * 1e-6)
    assert METRIC.read(rec) == pytest.approx(want, rel=1e-12)
    assert 0 < METRIC.read(rec) < 100


@pytest.mark.parametrize("trace", [None, {"calls": 0, "device": []},
                                   {"calls": 3, "device": []}],
                         ids=["missing", "no_calls", "no_kernels"])
def test_ssim_sums_roofline_is_absent_where_there_is_nothing_to_read(trace):
    rec = _rec([("torch", 100.0)])
    assert METRIC.read(rec) is None
    rec["trace"] = trace
    assert METRIC.read(rec) is None
    no_stage = _rec([("b13", 100.0)])
    no_stage["cost"]["stages"] = {}
    assert METRIC.read(no_stage) is None


def test_a_tiny_run_samples_the_score_and_leaves_b13_out_on_the_cpu(tiny_root):
    r = harness.run_cell(tiny_root, CELL, 2**31 + 29, 1.5, True, time.perf_counter(),
                         device="cpu")
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"max_abs_score"}
    assert 0.0 <= r["checks"]["max_abs_score"]["value"] <= CFG["limits"]["max_abs_score"]
    assert 0.0 < r["sampled_value_median"] < 100.0
    assert "ssim_sums_roofline" not in r["metrics"]
