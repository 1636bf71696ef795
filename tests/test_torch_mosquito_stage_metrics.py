"""The benchmark's MosquitoNR stage metrics (``portbench/metrics/
smooth_stage_ms.py``, ``restore_stage_ms.py``) on made-up traced slices, as
``portbench/trace.py`` records them (this machine has no card to trace):
in each op call, each CUDA runtime call that enqueues device work is paired
in order with one of the call's device operations and attributed to the
stage range that holds it; the metric is the median over the harness's op
calls; a call whose operations do not pair is left out; and the metric is
left out, never 0, where the slice, the stage spans or every pairing is
missing.  Imports no JAX."""

import pytest

from portbench.metrics import restore_stage_ms, smooth_stage_ms

SMOOTH, RESTORE = smooth_stage_ms.STAGE, restore_stage_ms.STAGE
STAGES = {SMOOTH: (2.0, 40.0), RESTORE: (41.0, 88.0)}


def _rec(calls, extra=(), window=(-10.0, 1e6)):
    """A slice of op calls 100 us apart on the host.  Call i's entry is a list
    of (stage or None, device us) launches, made in that order inside their
    stage's range (or before the stages, inside the op's range); `extra`
    adds (name, start, end) ranges to call 0 without a device operation.
    The device runs every operation in issue order, from 1000 us after its
    launch, and the profiler lists them in reverse."""
    cpu, launches, first = [], [], []
    for i, ops in enumerate(calls):
        first.append(len(launches))
        t0 = 100.0 * i
        cpu += [("portbench.op", t0, t0 + 90.0), ("vszip.op.mosquito_nr", t0 + 1.0, t0 + 89.0)]
        cpu += [(name, t0 + s, t0 + e) for name, (s, e) in STAGES.items()]
        for k, (stage, us) in enumerate(ops):
            s = t0 + (STAGES[stage][0] + 1.0 if stage else 0.2) + 2.0 * k
            name = "cudaMemcpyAsync" if us < 0 else "cudaLaunchKernel"
            cpu += [("aten::add", s - 0.1, s + 1.5), (name, s, s + 1.0)]
            launches.append((s, abs(us), us < 0))
        cpu += [("cudaEventRecord", t0 + 95.0, t0 + 96.0)]
    cpu += [(name, s, e) for name, s, e in extra]
    device, end = [], 0.0
    for s, us, copy in sorted(launches):
        start = max(end, s + 1000.0)
        end = start + us
        device.append({"name": "Memcpy DtoD (Device -> Device)" if copy else "add_kernel",
                       "start": start, "end": end, "copy": copy, "pageable": False})
    # each call's range on the device's timeline: its first operation's
    # start to its last's end
    bounds = first + [len(device)]
    ops = [(device[a]["start"], device[b - 1]["end"]) for a, b in zip(bounds, bounds[1:])]
    return {"trace": {"calls": len(calls), "window": window, "cpu": cpu,
                      "device": device[::-1], "ops": ops}}


def test_each_stage_reads_the_median_of_its_calls():
    rec = _rec([[(SMOOTH, 100.0), (SMOOTH, 200.0), (RESTORE, 50.0)],
                [(SMOOTH, 300.0), (SMOOTH, 300.0), (RESTORE, 70.0), (RESTORE, 5.0)],
                [(SMOOTH, 150.0), (SMOOTH, 250.0), (RESTORE, 60.0)]])
    assert smooth_stage_ms.read(rec) == pytest.approx(0.4)     # 300, 600, 400 us
    assert restore_stage_ms.read(rec) == pytest.approx(0.06)   # 50, 75, 60 us


def test_device_operations_pair_in_order_with_their_launches():
    """A copy pairs with its runtime call and counts for its stage; a
    ``cuLaunchKernel`` made inside a ``cudaLaunchKernel`` enqueues one
    operation; an operation launched outside both stages counts for
    neither."""
    calls = [[(None, 900.0), (SMOOTH, 100.0), (SMOOTH, -7.0), (RESTORE, 10.0)],
             [(SMOOTH, 100.0), (RESTORE, 10.0)]]
    rec = _rec(calls, extra=[("cuLaunchKernel", 5.2, 5.8)])
    assert [d["end"] - d["start"] for d in sorted(rec["trace"]["device"],
                                                  key=lambda d: d["start"])] == pytest.approx(
        [900.0, 100.0, 7.0, 10.0, 100.0, 10.0])
    assert smooth_stage_ms.read(rec) == pytest.approx((107.0 + 100.0) / 2 * 1e-3)
    assert restore_stage_ms.read(rec) == pytest.approx(0.01)


def test_a_calls_first_and_last_operations_are_its_own_despite_rounding():
    """The profiler's microseconds near 1.8e15 round to a quarter: a call's
    range on the device may start after its first operation starts and end
    before its last one ends."""
    calls = [[(SMOOTH, 100.0), (RESTORE, 10.0)], [(SMOOTH, 300.0), (RESTORE, 20.0)],
             [(SMOOTH, 200.0), (RESTORE, 30.0)]]
    rec = _rec(calls)
    rec["trace"]["ops"] = [(s + 0.25, e - 0.25) for s, e in rec["trace"]["ops"]]
    assert smooth_stage_ms.read(rec) == pytest.approx(0.2)
    assert restore_stage_ms.read(rec) == pytest.approx(0.02)


@pytest.mark.parametrize("metric", [smooth_stage_ms, restore_stage_ms])
def test_left_out_where_there_is_nothing_to_read(metric):
    calls = [[(SMOOTH, 100.0), (RESTORE, 10.0)], [(SMOOTH, 100.0), (RESTORE, 10.0)]]
    assert metric.read(_rec(calls)) is not None
    assert metric.read({"trace": None}) is None
    assert metric.read({}) is None
    rec = _rec(calls)
    rec["trace"]["calls"] = 0
    assert metric.read(rec) is None
    # the parent commit: the op's range and launches, no stage spans
    rec = _rec(calls)
    rec["trace"]["cpu"] = [e for e in rec["trace"]["cpu"] if e[0] not in (SMOOTH, RESTORE)]
    assert metric.read(rec) is None
    # the profiler lost an operation of every call: no call pairs
    rec = _rec(calls)
    del rec["trace"]["device"][3]
    del rec["trace"]["device"][0]
    assert metric.read(rec) is None
    # a call on the host with no range on the device's timeline
    rec = _rec(calls)
    del rec["trace"]["ops"][0]
    assert metric.read(rec) is None


@pytest.mark.parametrize("lost", [0, 2, 3], ids=["first", "middle", "last"])
def test_a_call_that_lost_an_operation_is_left_out(lost):
    """Calls of 200, 300 and 400 us of smoothing: the call that lost an
    operation (at its start, its middle or its end; the device list is in
    reverse) is left out, and the median is over the other two."""
    calls = [[(SMOOTH, 200.0), (RESTORE, 10.0)], [(SMOOTH, 300.0), (RESTORE, 20.0)],
             [(SMOOTH, 100.0), (SMOOTH, 300.0), (RESTORE, 30.0), (RESTORE, 1.0)]]
    rec = _rec(calls)
    assert smooth_stage_ms.read(rec) == pytest.approx(0.3)
    del rec["trace"]["device"][lost]
    assert smooth_stage_ms.read(rec) == pytest.approx(0.25)
    assert restore_stage_ms.read(rec) == pytest.approx(0.015)


def test_launches_outside_the_window_are_not_paired():
    """A slice whose window ends before the second call's launches: those
    launches, and their operations, are not in it."""
    rec = _rec([[(SMOOTH, 100.0), (RESTORE, 10.0)], [(SMOOTH, 40.0), (RESTORE, 30.0)]],
               window=(-10.0, 95.0))
    rec["trace"]["calls"] = 1
    rec["trace"]["device"] = sorted(rec["trace"]["device"], key=lambda d: d["start"])[:2]
    rec["trace"]["ops"] = rec["trace"]["ops"][:1]
    assert smooth_stage_ms.read(rec) == pytest.approx(0.1)
    assert restore_stage_ms.read(rec) == pytest.approx(0.01)
