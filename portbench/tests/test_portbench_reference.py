"""The plain references agree with ``vszip_tpu_torch``'s CPU path at a tiny
size, their controls do not, and the generator is deterministic per seed.
The plane ops' checks and work counts read what they read before metric ops
came in, on fixed seeded inputs."""

from __future__ import annotations

import json

import pytest
import torch

import vszip_tpu_torch as vt
from portbench import check, spec
from portbench.traffic import frames

from .conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CONFIGS = [json.loads((REPO / c["file"]).read_text()) for c in BENCH["configs"]]
# plane ops compare output planes; metric ops (``compare``) a frame prop
PLANE_CONFIGS = [c for c in CONFIGS if "compare" not in c]
TINY = [[64, 96], [32, 48], [32, 48]]
CPU = torch.device("cpu")


def _tiny(cfg):
    return {**cfg, "width": 96, "height": 64, "planes": TINY}


def _inputs(seed, n=3):
    return frames.make_planes(seed, n, TINY, 16, CPU)


@pytest.mark.parametrize("cfg", PLANE_CONFIGS, ids=[c["name"] for c in PLANE_CONFIGS])
@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_reference_agrees_with_the_program_cpu_path(cfg, seed):
    cfg = _tiny(cfg)
    ref = spec.load_file(REPO, "reference", cfg["reference"])
    planes = _inputs(seed)
    clip = vt.Clip.from_planes(planes, vt.get_format(cfg["format"]), device="cpu")
    out = getattr(vt, cfg["op"])(clip, **cfg["args"]).planes
    want = ref.run(planes, cfg)
    for o, w in zip(out, want):
        assert o.dtype == w.dtype and o.shape == w.shape
        d = (o.to(torch.int32) - w.to(torch.int32)).abs()
        assert int(d.max()) <= cfg["limits"]["max_abs_lsb"]
        assert 100.0 * int(torch.count_nonzero(d)) / d.numel() <= cfg["limits"]["off_share_pct"]


@pytest.mark.parametrize("cfg", PLANE_CONFIGS, ids=[c["name"] for c in PLANE_CONFIGS])
def test_control_breaks_the_limits(cfg):
    cfg = _tiny(cfg)
    ref = spec.load_file(REPO, "reference", cfg["reference"])
    planes = _inputs(7)
    exact = ref.run(planes, cfg)
    low = ref.run(planes, cfg, control=True)
    d = torch.cat([(a.to(torch.int32) - b.to(torch.int32)).abs().reshape(-1)
                   for a, b in zip(exact, low)])
    share = 100.0 * int(torch.count_nonzero(d)) / d.numel()
    assert int(d.max()) > cfg["limits"]["max_abs_lsb"] or share > cfg["limits"]["off_share_pct"]


@pytest.mark.parametrize("cfg", CONFIGS, ids=[c["name"] for c in CONFIGS])
def test_work_counts_every_plane_read_and_written_once(cfg):
    """A plane op reads and writes each plane its call selects (every plane
    where the call names none); a metric op reads every plane of its two
    clips and writes no plane."""
    ref = spec.load_file(REPO, "reference", cfg["reference"])
    nbytes, int_ops, f32_ops = ref.work(cfg, 64)
    areas = [h * w for h, w in cfg["planes"]]
    if "compare" in cfg:
        want = 2 * 64 * 2 * sum(areas)          # two clips read, nothing written
    else:
        selected = cfg["args"].get("planes", range(len(areas)))
        want = 2 * 64 * 2 * sum(areas[p] for p in selected)   # read and written
    assert nbytes == want
    assert int_ops + f32_ops > 0


# (bytes, integer operations, f32 operations) of a 64-frame batch, and the
# tiny check's readings, as the benchmark read them before metric ops
PLANE_READINGS = {
    "boxblur_r13_yuv420p16_1080p": ((796262400, 2189721600, 0), 7705),
    "bilateral_s2r2_yuv420p16_1080p": ((796262400, 0, 20304691200), 6887),
    "boxblur_r13_5pass_yuv420p16_1080p": ((796262400, 11943936000, 0), 8218),
    "mosquito_nr_yuv420p16_1080p": ((530841600, 20503756800, 0), 6733),
}


@pytest.mark.parametrize("cfg", PLANE_CONFIGS, ids=[c["name"] for c in PLANE_CONFIGS])
def test_plane_ops_read_as_before(cfg):
    """``work`` and ``check.compare`` of each plane op give the numbers they
    gave before the harness took metric ops, on fixed seeded inputs: the
    reference's own output (nothing off), and the same with a seeded bump of
    k + 1 steps on every (k + 3)-th sample of plane k."""
    work, off = PLANE_READINGS[cfg["name"]]
    ref = spec.load_file(REPO, "reference", cfg["reference"])
    assert ref.work(cfg, 64) == work
    cfg = _tiny(cfg)
    planes = frames.make_planes(2**31 + 77, 3, TINY, 16, CPU)
    want = ref.run(planes, cfg)
    bumped = []
    for k, w in enumerate(want):
        step = (torch.arange(w.numel()).view(w.shape) % (k + 3) == 0).to(torch.int32) * (k + 1)
        bumped.append((w.to(torch.int32) + step).clamp(0, 65535).to(w.dtype))
    got = check.compare(ref, cfg, planes, tuple(bumped), CPU)
    same = check.compare(ref, cfg, planes, want, CPU)
    assert got == {"max_abs": 3.0, "off": off, "count": 27648}
    assert same == {"max_abs": 0.0, "off": 0, "count": 27648}
    nums = check.numbers([got, same], cfg["limits"])
    assert nums == {"max_abs_lsb": {"value": 3.0, "limit": cfg["limits"]["max_abs_lsb"]},
                    "off_share_pct": {"value": 100.0 * off / (2 * 27648),
                                      "limit": cfg["limits"]["off_share_pct"]}}


def test_bilateral_derives_the_plugins_windows():
    ref = spec.load_file(REPO, "reference", "bilateral")
    cfg = next(c for c in CONFIGS if c["op"] == "bilateral")
    assert ref.plane_params(cfg) == [(2.0, 2.0, 3, 2), (1.0, 2.0, 2, 1), (1.0, 2.0, 2, 1)]


def test_generator_is_deterministic_per_seed_and_uses_the_full_range():
    a = _inputs(123)
    b = _inputs(123)
    c = _inputs(124)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert [tuple(p.shape) for p in a] == [tuple(p.shape) for p in c]
    assert a[0].dtype == torch.uint16
    for seed in (123, 2**31 + 9):
        luma = frames.make_planes(seed, 1, [(1080, 1920)], 16, CPU)[0].to(torch.int32)
        assert int(luma.min()) == 0 and int(luma.max()) == 65535
