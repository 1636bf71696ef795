"""The plain references agree with ``vszip_tpu_torch``'s CPU path at a tiny
size, their controls do not, and the generator is deterministic per seed."""

from __future__ import annotations

import json

import pytest
import torch

import vszip_tpu_torch as vt
from portbench import spec
from portbench.traffic import frames

from .conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CONFIGS = [json.loads((REPO / c["file"]).read_text()) for c in BENCH["configs"]]
TINY = [[64, 96], [32, 48], [32, 48]]
CPU = torch.device("cpu")


def _tiny(cfg):
    return {**cfg, "width": 96, "height": 64, "planes": TINY}


def _inputs(seed, n=3):
    return frames.make_planes(seed, n, TINY, 16, CPU)


@pytest.mark.parametrize("cfg", CONFIGS, ids=[c["name"] for c in CONFIGS])
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


@pytest.mark.parametrize("cfg", CONFIGS, ids=[c["name"] for c in CONFIGS])
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
    ref = spec.load_file(REPO, "reference", cfg["reference"])
    nbytes, int_ops, f32_ops = ref.work(cfg, 64)
    assert nbytes == 2 * 2 * 64 * (1920 * 1080 + 2 * 960 * 540)
    assert int_ops + f32_ops > 0


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
