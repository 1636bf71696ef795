"""The port's spans and launch counters (``vszip_tpu_torch.trace``), on the
CPU: off unless someone looks, nested under ``collect()`` with parent ids and
self times, in the profiler's trace by name and on its clock, at every op
entry point, kernel wrapper and stage of ``process_stream``."""

import importlib
import inspect
import types

import numpy as np
import pytest
import torch

import vszip_tpu_torch as vt
from vszip_tpu_torch import trace
from vszip_tpu_torch.kernels import (bilateral, bilateral_dither, boxblur, checkmate, clahe,
                                     comb_mask, compress, deband, eedi3, mosquito_nr, ssim,
                                     xpsnr)

# the op module (the package exports the op function under the same name)
MOSQUITO = importlib.import_module("vszip_tpu_torch.ops.mosquito_nr")

KERNEL_MODULES = (bilateral, bilateral_dither, boxblur, checkmate, clahe, comb_mask, compress,
                  deband, eedi3, mosquito_nr, ssim, xpsnr)
# each kernel wrapper and the launch counter its span is named after
WRAPPERS = [(boxblur, "ct_blur_int", "ct_blur_int"), (boxblur, "rt_blur_h", "rt_blur_h"),
            (boxblur, "rt_blur_v_multi", "rt_blur_v_multi"), (boxblur, "rt_blur_v", "rt_blur_v"),
            (bilateral, "bilateral_window", "bilateral_window"),
            (bilateral_dither, "dense_blur", "dense_blur"),
            (bilateral_dither, "subspl_blur", "subspl_blur"),
            (checkmate, "checkmate", "checkmate"), (clahe, "clahe8_lookup", "clahe8_lookup"),
            (comb_mask, "comb_mask", "comb_mask"),
            (compress, "compress_plane", "compress_plane"),
            (deband, "deband_center", "deband_center"),
            (deband, "deband_m2_center", "deband_m2_center"),
            (eedi3, "eedi3_fused", "eedi3_fused"), (eedi3, "eedi3_fused_hp", "eedi3_fused_hp"),
            (eedi3, "vcheck", "vcheck"),
            (mosquito_nr, "mosquito_nr_smooth", "mosquito_nr_smooth"),
            (ssim, "ssim_partials", "ssim_sums"),
            (xpsnr, "luma_stats", "luma_stats"), (xpsnr, "chroma_sse", "chroma_sse"),
            (xpsnr, "chroma_sse_uv", "chroma_sse")]
BOXBLUR = ["vszip.op.boxblur", "vszip.op.boxblur.derive"] + [
    "vszip.op.boxblur.plane", "vszip.kernel.ct_blur_int"] * 3


def _clip(frames=2, seed=0):
    rng = np.random.default_rng(seed)
    planes = tuple(rng.integers(0, 65536, (frames, h, w), dtype=np.uint16)
                   for h, w in ((64, 96), (32, 48), (32, 48)))
    return planes, vt.get_format("YUV420P16")


def _names(t):
    """Span names in the order they opened."""
    return [s[0] for s in sorted(t.spans, key=lambda s: (s[3], s[1]))]


def _span_name(fn):
    """The span name a ``trace.spanned`` wrapper opens."""
    cells = [c.cell_contents for c in fn.__closure__ or ()]
    return next(c for c in cells if isinstance(c, str))


class _Clock:
    """A ``time`` stand-in whose ``time_ns`` returns the given stamps in turn."""

    def __init__(self, *stamps):
        self.stamps = iter(stamps)

    def time_ns(self):
        return next(self.stamps)


def test_off_the_span_is_the_shared_no_op_and_nothing_is_recorded(monkeypatch):
    assert not torch.autograd._profiler_enabled()
    assert trace.span("vszip.test") is trace.OFF
    assert trace.span("vszip.other") is trace.OFF
    # no clock is read: a clock that raises is never called
    monkeypatch.setattr(trace, "time", types.SimpleNamespace(time_ns=None))
    planes, fmt = _clip()
    out = vt.boxblur(vt.Clip.from_planes(planes, fmt, device="cpu"), hradius=3, vradius=3)
    assert out.planes[0].shape == (2, 64, 96)
    monkeypatch.undo()
    with trace.collect() as t:
        pass
    assert t.spans == [] and t.launches == {}


def test_collect_nests_spans_with_parent_ids_and_self_times(monkeypatch):
    monkeypatch.setattr(trace, "time", _Clock(0, 10, 40, 50, 60, 100, 200, 230))
    with trace.collect() as t:
        with trace.span("vszip.outer"):
            with trace.span("vszip.inner"):
                pass
            with trace.span("vszip.inner"):
                pass
        with trace.span("vszip.next"):
            pass
    by_name = {}
    for name, sid, parent, start, end in t.spans:
        by_name.setdefault(name, []).append((sid, parent, start, end))
    (outer_id, outer_parent, _, _), = by_name["vszip.outer"]
    assert outer_parent == 0 and by_name["vszip.next"][0][1] == 0
    assert [p for _, p, _, _ in by_name["vszip.inner"]] == [outer_id, outer_id]
    totals = t.totals()
    assert totals["vszip.outer"] == {"count": 1, "total_s": pytest.approx(100e-9),
                                     "self_s": pytest.approx(60e-9)}
    assert totals["vszip.inner"] == {"count": 2, "total_s": pytest.approx(40e-9),
                                     "self_s": pytest.approx(40e-9)}
    assert totals["vszip.next"]["self_s"] == pytest.approx(30e-9)


def test_a_span_closes_when_its_block_raises():
    @trace.spanned("vszip.test.raises")
    def boom():
        raise ValueError("boom")

    with trace.collect() as t:
        with pytest.raises(ValueError, match="boom"):
            boom()
        with trace.span("vszip.test.after"):
            pass
    assert [(s[0], s[2]) for s in t.spans] == [("vszip.test.raises", 0),
                                              ("vszip.test.after", 0)]


def test_nested_collects_both_see_the_inner_spans():
    with trace.collect() as outer:
        with trace.span("vszip.test.a"):
            pass
        with trace.collect() as inner:
            with trace.span("vszip.test.b"):
                pass
    assert _names(outer) == ["vszip.test.a", "vszip.test.b"]
    assert _names(inner) == ["vszip.test.b"]


@pytest.mark.parametrize("name", vt.ops.__all__)
def test_every_op_is_a_span_and_keeps_its_name_doc_and_signature(name):
    fn = getattr(vt, name)
    assert fn is getattr(vt.ops, name)
    inner = fn.__wrapped__
    assert fn.__name__ == inner.__name__ == name
    assert fn.__doc__ == inner.__doc__
    assert fn.__module__ == inner.__module__
    assert inspect.signature(fn) == inspect.signature(inner)
    assert _span_name(fn) == f"vszip.op.{name}"


@pytest.mark.parametrize("module,wrapper,key", WRAPPERS,
                         ids=[f"{m.__name__.rsplit('.', 1)[1]}.{w}" for m, w, _ in WRAPPERS])
def test_every_kernel_wrapper_is_a_span_named_after_its_counter(module, wrapper, key):
    fn = getattr(module, wrapper)
    assert fn.__name__ == wrapper and inspect.signature(fn) == inspect.signature(fn.__wrapped__)
    assert _span_name(fn) == f"vszip.kernel.{key}"
    assert key in module.LAUNCHES


def test_boxblur_and_bilateral_stay_within_their_span_budgets():
    planes, fmt = _clip()
    c = vt.Clip.from_planes(planes, fmt, device="cpu")
    with trace.collect() as t:
        vt.boxblur(c, hradius=13, vradius=13)
    assert _names(t) == BOXBLUR            # the budget is 8
    ops = [s for s in t.spans if s[0] == "vszip.op.boxblur"]
    assert len(ops) == 1 and all(s[2] != 0 for s in t.spans if s is not ops[0])
    with trace.collect() as t:
        vt.bilateral(c, sigmaS=2.0, sigmaR=2.0, planes=[0, 1, 2])
    # algorithm 2 on every plane: the planes' work is under the window's span
    assert _names(t) == ["vszip.op.bilateral", "vszip.op.bilateral.derive",
                         "vszip.kernel.bilateral_window"]  # the budget is 40
    with trace.collect() as t:
        vt.bilateral(c, sigmaS=2.0, sigmaR=0.1, algorithm=[1, 2, 2])
    assert _names(t) == ["vszip.op.bilateral", "vszip.op.bilateral.derive",
                         "vszip.op.bilateral.plane", "vszip.kernel.bilateral_window"]
    totals = t.totals()
    assert totals["vszip.op.bilateral"]["self_s"] <= totals["vszip.op.bilateral"]["total_s"]


def test_a_derive_span_holds_the_validation_error():
    planes, fmt = _clip()
    c = vt.Clip.from_planes(planes, fmt, device="cpu")
    with trace.collect() as t:
        with pytest.raises(vt.VSZipError, match="hradius too large"):
            vt.boxblur(c, hradius=40, vradius=1)
    assert _names(t) == ["vszip.op.boxblur", "vszip.op.boxblur.derive"]


def _stream(sink=True, **kw):
    planes, fmt = _clip(frames=6, seed=1)
    src = vt.ArraySource(planes, fmt)
    got = []
    with trace.collect() as t:
        vt.process_stream(src, lambda c: vt.boxblur(c, hradius=2, vradius=2), batch=2,
                          sink=(lambda i, c: got.append(i)) if sink else None, **kw)
    return t, got


def _stages(t):
    return [n for n in _names(t) if n.startswith("vszip.stream.")]


def test_process_stream_gives_its_stages_in_order_on_the_cpu():
    t, got = _stream(device="cpu")
    assert got == [0, 2, 4]
    load = ["vszip.stream.source", "vszip.stream.fill"]
    drain = ["vszip.stream.readback", "vszip.stream.sink"]
    op = ["vszip.stream.op"]
    assert _stages(t) == (load + op + load + op + load + drain + op + drain + drain)
    # the ops run inside the stage that runs them
    ids = {s[1]: s[0] for s in t.spans}
    assert all(ids[s[2]] == "vszip.stream.op" for s in t.spans if s[0] == "vszip.op.boxblur")
    totals = t.totals()
    assert totals["vszip.stream.op"]["count"] == 3
    assert totals["vszip.op.boxblur"]["count"] == 3
    assert totals["vszip.stream.fill"]["count"] == 3


def test_process_stream_without_a_sink_reads_back_props_only():
    t, _ = _stream(sink=False, device="cpu")
    totals = t.totals()
    assert totals["vszip.stream.readback"]["count"] == 3 and "vszip.stream.sink" not in totals


def test_process_stream_over_a_mesh_gives_one_op_span_per_entry():
    t, got = _stream(mesh=vt.parallel.frames_mesh(devices=["cpu", "cpu"]))
    assert got == [0, 2, 4]
    totals = t.totals()
    assert totals["vszip.stream.op"]["count"] == 6       # 3 chunks x 2 entries
    assert totals["vszip.stream.gather"]["count"] == 3
    assert totals["vszip.op.boxblur"]["count"] == 6
    stages = _stages(t)
    first = stages[:stages.index("vszip.stream.gather") + 1]
    assert first == ["vszip.stream.source", "vszip.stream.fill", "vszip.stream.op",
                     "vszip.stream.op", "vszip.stream.gather"]


def _registered(m):
    """A kernel module's registered counter dicts: its LAUNCHES, and
    BoxBlur's VARIANTS."""
    return [m.LAUNCHES] + ([m.VARIANTS] if m is boxblur else [])


def _every_registered():
    """Every registered counter dict: the kernel modules', and MosquitoNR's
    PLANES, which its op module registers."""
    return [d for m in KERNEL_MODULES for d in _registered(m)] + [MOSQUITO.PLANES]


def test_counters_are_the_modules_launches():
    view = trace.counters()
    want = {}
    for d in _every_registered():
        assert not set(d) & set(want)
        want.update(d)
    assert dict(view) == want and len(view) == len(want)
    with pytest.raises(TypeError):
        view["ct_blur_int"] = 1
    registered = _every_registered()
    saved = [dict(d) for d in registered]
    try:
        before = view["ct_blur_int"]
        with trace.collect() as t:
            boxblur.LAUNCHES["ct_blur_int"] += 3
            assert view["ct_blur_int"] == before + 3
        assert t.launches == {"ct_blur_int": 3}
        for d in registered:
            d[next(iter(d))] += 1
        trace.reset_launches()
        assert set(view.values()) == {0}
        assert all(v == 0 for d in registered for v in d.values())
    finally:
        for d, was in zip(registered, saved):
            d.update(was)
    with pytest.raises(KeyError):
        view["no_such_kernel"]


def test_a_launch_counter_name_is_registered_once():
    assert trace.register_launches(boxblur.LAUNCHES) is boxblur.LAUNCHES
    assert trace.register_launches(boxblur.VARIANTS) is boxblur.VARIANTS
    assert len(trace.counters()) == sum(len(d) for d in _every_registered())
    with pytest.raises(ValueError, match="registered twice"):
        trace.register_launches({"ct_blur_int": 0})
    with pytest.raises(ValueError, match="registered twice"):
        trace.register_launches({"v_chip": 0})


def test_boxblur_variant_counters_are_in_the_view_and_the_cpu_path_never_counts_them():
    """Which kernel variant each BoxBlur launch took (B1 in one launch
    ``ct_fused`` or its two stages ``ct_two_stage``; ``v_chip`` or the column
    walk ``v_fixed``; ``h_fixed`` one warp a row in registers, or a block a
    row in shared memory or with global scratch) is a registered counter; the
    plain versions on the CPU launch nothing."""
    view = trace.counters()
    assert set(boxblur.VARIANTS) == {"ct_fused", "ct_two_stage", "v_chip", "v_fixed",
                                     "h_fixed_warp", "h_fixed_shared", "h_fixed_scratch"}
    assert set(boxblur.VARIANTS) <= set(view)
    planes, fmt = _clip()
    c = vt.Clip.from_planes(planes, fmt, device="cpu")
    before = dict(view)
    with trace.collect() as t:
        vt.boxblur(c, hradius=13, hpasses=5, vradius=13, vpasses=5)
        vt.boxblur(c, hradius=4, vradius=9)
        vt.boxblur(c, hradius=13, vradius=13)
    assert t.launches == {} and dict(view) == before
    saved = dict(boxblur.VARIANTS)
    try:
        boxblur.VARIANTS["v_chip"] += 2
        boxblur.VARIANTS["h_fixed_warp"] += 1
        assert view["v_chip"] == saved["v_chip"] + 2
        trace.reset_launches()
        assert all(view[k] == 0 for k in boxblur.VARIANTS)
        assert set(boxblur.VARIANTS.values()) == {0}
    finally:
        boxblur.VARIANTS.update(saved)


def _profiled_events(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
            for ev in prof.profiler.kineto_results.events()]


def test_under_the_profiler_the_ranges_appear_by_name():
    """The op's range and process_stream's stages; the finer spans inside an
    op stay out of the profiler's trace."""
    planes, fmt = _clip()
    c = vt.Clip.from_planes(planes, fmt, device="cpu")
    events = _profiled_events(lambda: vt.boxblur(c, hradius=13, vradius=13))
    assert [n for n, _, _ in events if n.startswith("vszip.")] == ["vszip.op.boxblur"]
    op = next((s, e) for n, s, e in events if n == "vszip.op.boxblur")
    assert all(op[0] <= s and e <= op[1] for n, s, e in events if n.startswith("aten::"))
    src = vt.SyntheticSource(lambda a, b: tuple(p[a:b] for p in planes), fmt, 2)
    events = _profiled_events(lambda: vt.process_stream(
        src, lambda x: vt.boxblur(x, hradius=3, vradius=3), batch=1, sink=lambda i, x: None,
        device="cpu"))
    names = [n for n, _, _ in sorted(events, key=lambda e: e[1]) if n.startswith("vszip.")]
    assert names == ["vszip.stream.source", "vszip.stream.fill", "vszip.stream.op",
                     "vszip.op.boxblur", "vszip.stream.source", "vszip.stream.fill",
                     "vszip.stream.op", "vszip.op.boxblur", "vszip.stream.readback",
                     "vszip.stream.sink", "vszip.stream.readback", "vszip.stream.sink"]


def test_a_span_left_out_of_the_profiler_is_still_collected():
    @trace.spanned("vszip.test.fine", profiled=False)
    def fine():
        with trace.span("vszip.test.finer", profiled=False):
            pass

    def run():
        with trace.collect() as t, trace.span("vszip.test.coarse"):
            fine()
        box["t"] = t

    box = {}
    events = _profiled_events(run)
    assert [n for n, _, _ in events if n.startswith("vszip.")] == ["vszip.test.coarse"]
    assert _names(box["t"]) == ["vszip.test.coarse", "vszip.test.fine", "vszip.test.finer"]
    assert trace.span("vszip.test.fine", profiled=False) is trace.OFF


def test_a_collected_span_and_its_profiler_range_share_the_clock():
    planes, fmt = _clip()
    c = vt.Clip.from_planes(planes, fmt, device="cpu")
    box = {}

    def run():
        with trace.collect() as t:
            vt.boxblur(c, hradius=13, vradius=13)
        box["t"] = t

    events = _profiled_events(run)
    ranges = {n: (s, e) for n, s, e in events if n.startswith("vszip.")}
    assert list(ranges) == ["vszip.op.boxblur"]
    spans = {s[0]: (s[3], s[4]) for s in box["t"].spans}
    for name, (s, e) in ranges.items():
        cs, ce = spans[name]
        assert abs(cs - s) < 1e6 and abs(ce - e) < 1e6, (name, cs - s, ce - e)
