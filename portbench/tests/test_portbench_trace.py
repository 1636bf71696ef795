"""The traced slice's choice and its breakdown, on made-up slices (this
machine has no card to trace)."""

from __future__ import annotations

import torch

from portbench import spec, trace

from .conftest import REPO


class _Null:
    def __exit__(self, *a):
        pass

    def stop(self):
        pass


def _slice(calls, kernels_per_call, us_per_kernel=100.0):
    device = [{"name": "k", "start": i * 200.0, "end": i * 200.0 + us_per_kernel, "copy": False,
               "pageable": False} for i in range(int(calls * kernels_per_call))]
    return {"calls": calls, "device": device, "ops": [], "cpu": [], "window_s": 1.0,
            "busy_s": 0.5}


def _tracer_over(monkeypatch, slices):
    it = iter(slices)
    monkeypatch.setattr(trace, "_records", lambda prof, calls: next(it))
    t = trace.Tracer(True, torch.device("cpu"), seconds=1.0)
    for _ in slices:
        if t.done:
            break
        t.prof, t.mark = _Null(), _Null()
        t._stop()
    return t


def test_the_fuller_of_two_agreeing_slices_is_kept(monkeypatch):
    a, b = _slice(100, 5.98), _slice(100, 6.0)
    t = _tracer_over(monkeypatch, [a, b])
    assert t.done and t.kept is b
    t = _tracer_over(monkeypatch, [_slice(100, 6.0), _slice(100, 5.98)])
    assert len(t.kept["device"]) == 600


def test_no_slice_is_kept_when_none_agree(monkeypatch):
    slices = [_slice(100, 6.0, 100.0), _slice(100, 6.0, 150.0), _slice(100, 5.0),
              _slice(100, 6.0, 80.0)]
    t = _tracer_over(monkeypatch, slices)
    assert t.done and t.kept is None
    assert len(t.notes) == trace.TRIES


def test_breakdown_names_gaps_by_the_innermost_host_range():
    rec = {"device": [{"name": "a", "start": 0.0, "end": 10.0, "copy": False},
                      {"name": "b", "start": 30.0, "end": 40.0, "copy": False},
                      {"name": "a", "start": 40.0, "end": 45.0, "copy": False}],
           "cpu": [("outer", 0.0, 100.0), ("portbench.wait", 12.0, 29.0)],
           "merged": [[0.0, 10.0], [30.0, 45.0]], "window": (0.0, 50.0)}
    b = trace.breakdown(rec)
    assert [n for n, _ in b["device_ops"]] == ["a", "b"]
    assert [n for n, _ in b["idle_gaps"]] == ["portbench.wait", "outer"]
    assert [round(v * 1e6, 9) for _, v in b["device_ops"] + b["idle_gaps"]] == [15, 10, 20, 5]


def _read(metric, rec):
    return spec.load_file(REPO, "metrics", metric).read({"trace": rec})


def test_busy_share_leaves_out_copies_to_and_from_pageable_memory():
    dev = [{"name": "k", "start": 0.0, "end": 300.0, "copy": False, "pageable": False},
           {"name": "Memcpy HtoD (Pinned -> Device)", "start": 200.0, "end": 400.0,
            "copy": True, "pageable": False},
           {"name": "Memcpy DtoH (Device -> Pageable)", "start": 500.0, "end": 900.0,
            "copy": True, "pageable": True}]
    rec = {"device": dev, "window": (0.0, 1000.0), "window_s": 1e-3}
    assert _read("device_busy_share", rec) == 40.0
    assert _read("device_busy_share", {**rec, "device": dev[2:]}) is None
    assert trace.union(dev, (100.0, 1000.0)) == ([[100.0, 400.0], [500.0, 900.0]], 700.0)


def test_op_device_ms_is_the_median_device_span_of_the_op_calls():
    rec = {"ops": [(0.0, 900.0), (1000.0, 1850.0), (2000.0, 2860.0)]}
    assert _read("op_device_ms", rec) == 0.86
    assert _read("op_device_ms", {"ops": []}) is None
