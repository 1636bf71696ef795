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


def test_the_fullest_slice_is_kept(monkeypatch):
    slices = [_slice(100, 5.9), _slice(100, 6.0), _slice(100, 5.95), _slice(100, 6.0, 99.0)]
    t = _tracer_over(monkeypatch, slices)
    assert not t.done and t.kept is None
    t.finish()
    assert t.done and t.kept is slices[1]


def test_a_slice_timed_short_is_not_kept(monkeypatch):
    slices = [_slice(100, 2.99), _slice(100, 3.0, 85.0), _slice(100, 2.99), _slice(100, 2.98)]
    t = _tracer_over(monkeypatch, slices)
    t.finish()
    assert t.kept is slices[0]


def test_the_fullest_is_kept_where_no_time_is_near_the_median(monkeypatch):
    slices = [_slice(100, 5.0, 100.0), _slice(100, 6.0, 150.0)]
    t = _tracer_over(monkeypatch, slices)
    t.finish()
    assert t.kept is slices[1]


def test_slices_are_taken_up_to_tries(monkeypatch):
    slices = [_slice(100, 6.0 - 0.01 * i) for i in range(trace.TRIES + 2)]
    t = _tracer_over(monkeypatch, slices)
    assert t.done and t.tries == trace.TRIES == len(t.notes)
    t.finish()
    assert t.kept is slices[0]


def test_no_slice_is_kept_without_device_work(monkeypatch):
    t = _tracer_over(monkeypatch, [_slice(100, 0.0), _slice(0, 0.0)])
    t.finish()
    assert t.done and t.kept is None


def test_a_slice_cut_by_the_windows_close_is_read_only_when_first(monkeypatch):
    a, b = _slice(100, 6.0), _slice(3, 6.0)
    t = _tracer_over(monkeypatch, [a])
    monkeypatch.setattr(trace, "_records", lambda prof, calls: b)
    t.prof, t.mark = _Null(), _Null()
    t.finish()
    assert t.kept is a and "cut" in t.notes[-1]
    t = trace.Tracer(True, torch.device("cpu"), seconds=1.0)
    t.prof, t.mark = _Null(), _Null()
    t.finish()
    assert t.kept is b


def test_the_first_slice_starts_a_share_into_the_window():
    t = trace.Tracer(True, torch.device("cpu"), seconds=2.0)
    t.begin(100.0, 30.0)
    assert t.start_at == 100.0 + trace.LEAD * 30.0


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
