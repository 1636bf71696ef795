"""Spans and launch counters: where the host's time goes inside the port.

Spans are named ``vszip.<layer>.<what>`` and sit only at layer boundaries,
never per tap, row or frame:

* every public op: ``vszip.op.<name>``; inside BoxBlur and Bilateral also
  ``vszip.op.<name>.derive`` (validation and create-time derivation) and
  ``vszip.op.<name>.plane`` (one processed plane); inside MosquitoNR
  ``vszip.op.mosquito_nr.smooth`` and ``.restore``, a processed plane's two
  stages;
* every hand-written kernel wrapper: ``vszip.kernel.<launch counter>`` (its
  checks, output allocation and launches; on the CPU, its plain version);
* ``process_stream``: ``vszip.stream.source`` (the source call), ``.fill``
  (the staging fill that ``STATS["fill_s"]`` times), ``.wait`` (a ring
  slot's wait for its last copies; card only), ``.copy`` (the host's enqueue
  of one part's H2D copy; card only), ``.op`` (one per mesh entry),
  ``.gather``, ``.readback`` (a chunk's planes and props to the host) and
  ``.sink``.

A span records only while someone looks:

* with no ``collect()`` active and no torch profiler running, ``span``
  returns one shared no-op object: no allocation, no clock read;
* under a running ``torch.profiler``, the ops' and ``process_stream``'s
  spans open a record-function range of their name, so they sit in the
  profiler's trace beside torch's own ops (not a user annotation: no range
  of its own on the device's timeline).  The finer spans inside an op
  (``.derive``, ``.plane``, ``vszip.kernel.*``, opened with
  ``profiled=False``) do not: a range costs the host about 2 us under the
  profiler, and eight of them in each BoxBlur call left a profiled H100 up
  to 6 points less busy than without them.  MosquitoNR's two stage spans
  are profiled all the same: a plane's two ranges sit among some 300
  plain-torch launches and over 100 ms of device work at 1080p, and the
  benchmark reads from the profiler's trace which stage launched each
  device operation;
* under ``collect()``, every span appends ``(name, id, parent id, start,
  end)`` to the collection, stamped with ``time.time_ns()``, the clock the
  profiler stamps its CPU events with: the two line up with no conversion.

``counters()`` is a read-only view of the kernel wrappers' launch counters
by kernel name: the modules' own ``LAUNCHES`` dicts, and BoxBlur's
``VARIANTS`` (the kernel variant each launch took: ``ct_fused`` or
``ct_two_stage``; ``v_chip`` or ``v_fixed``; ``h_fixed_warp``,
``h_fixed_shared`` or ``h_fixed_scratch``),
which each kernel module registers here, and MosquitoNR's ``PLANES`` (planes
smoothed, restored, and whose LL bands were mixed), which its op module
registers.  ``reset_launches()`` zeroes every
registered dict in place.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from collections.abc import Mapping

import torch

_profiling = torch.autograd._profiler_enabled
_Range = getattr(torch._C._profiler, "_RecordFunctionFast", torch.profiler.record_function)

_collecting: list = []        # the active collect()s' traces, outermost first
_open = threading.local()     # per thread: ids of the open collected spans
_ids = itertools.count(1)
_launches: list[dict] = []    # the kernel modules' counter dicts, in registration order


class _Off:
    """The span of a run nobody looks at."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _Span:
    __slots__ = ("name", "profiled", "range", "id", "parent", "start")

    def __init__(self, name: str, profiled: bool):
        self.name = name
        self.profiled = profiled
        self.range = None
        self.id = 0

    def __enter__(self):
        if self.profiled and _profiling():
            self.range = _Range(self.name)
            self.range.__enter__()
        if _collecting:
            stack = _stack()
            self.parent = stack[-1] if stack else 0
            self.id = next(_ids)
            stack.append(self.id)
            self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self.id:
            end = time.time_ns()
            _stack().pop()
            rec = (self.name, self.id, self.parent, self.start, end)
            for t in _collecting:
                t.spans.append(rec)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def _stack() -> list:
    try:
        return _open.ids
    except AttributeError:
        _open.ids = []
        return _open.ids


def span(name: str, profiled: bool = True):
    """A context manager that records `name` while someone looks, else the
    shared no-op ``OFF``; with `profiled` false, under ``collect()`` only."""
    if _collecting:
        return _Span(name, profiled)
    # under the profiler alone, its range itself: no Python frame of ours
    return _Range(name) if profiled and _profiling() else OFF


def spanned(name: str, profiled: bool = True):
    """Decorator: every call of the function is a span `name` (see
    ``span``).  The function keeps its name, docstring and signature."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name, profiled):
                return fn(*args, **kwargs)
        return call
    return wrap


class Counters(Mapping):
    """The registered launch counters, by kernel name, read live."""

    def __getitem__(self, key):
        for d in _launches:
            if key in d:
                return d[key]
        raise KeyError(key)

    def __iter__(self):
        for d in _launches:
            yield from d

    def __len__(self):
        return sum(len(d) for d in _launches)

    def __repr__(self):
        return f"Counters({dict(self)})"


_COUNTERS = Counters()


def counters() -> Counters:
    return _COUNTERS


def reset_launches() -> None:
    """Zero every registered counter in place."""
    for d in _launches:
        for k in d:
            d[k] = 0


def register_launches(launches: dict) -> dict:
    """Register a kernel module's ``LAUNCHES``, or another dict of its
    counters (the same dict, not a copy); returns it.  A name belongs to one
    dict."""
    if not any(d is launches for d in _launches):
        clash = set(launches).intersection(_COUNTERS)
        if clash:
            raise ValueError(f"vszip_tpu_torch: launch counters {sorted(clash)} are registered "
                             "twice")
        _launches.append(launches)
    return launches


class Trace:
    """What one ``collect()`` saw: ``spans``, ``(name, id, parent id, start
    ns, end ns)`` in the order they closed (parent id 0 at the top), and,
    once it has ended, ``launches``, the counters' changes over it."""

    def __init__(self):
        self.spans: list[tuple] = []
        self.launches: dict[str, int] = {}
        self._before = dict(_COUNTERS)

    def _end(self) -> None:
        now = dict(_COUNTERS)
        self.launches = {k: v - self._before.get(k, 0) for k, v in now.items()
                         if v != self._before.get(k, 0)}

    def totals(self) -> dict[str, dict]:
        """Per span name: ``count``, ``total_s`` and ``self_s``, its time less
        the time of the spans opened inside it."""
        inner: dict[int, int] = {}
        for _, _, parent, start, end in self.spans:
            inner[parent] = inner.get(parent, 0) + end - start
        out: dict[str, dict] = {}
        for name, sid, _, start, end in self.spans:
            t = out.setdefault(name, {"count": 0, "total_s": 0.0, "self_s": 0.0})
            t["count"] += 1
            t["total_s"] += (end - start) * 1e-9
            t["self_s"] += (end - start - inner.get(sid, 0)) * 1e-9
        return out


@contextlib.contextmanager
def collect():
    """Record every span opened inside the block (in any thread) into the
    ``Trace`` it yields."""
    t = Trace()
    _collecting.append(t)
    try:
        yield t
    finally:
        _collecting.remove(t)
        t._end()
