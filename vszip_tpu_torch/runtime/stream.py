"""Streaming executor: run an op over a clip larger than device memory.

The PyTorch counterpart of ``vszip_tpu.runtime.stream``: the same sources,
keywords, chunking, halo and prop semantics.  The source yields host frame
ranges on demand (never materializing the whole clip); each chunk
``[start-overlap, start+batch+overlap)`` runs through the op and its halo
frames are trimmed from the outputs, so a temporal op with radius <= overlap
gives exactly the resident result.

On the card the host-to-device copies are double-buffered:

* the source's NumPy frames are copied (by torch's multi-threaded copy) into
  one of two page-locked staging buffers (allocated once per call, sized to
  the largest chunk), after that buffer's previous copy has finished;
* the chunk goes to the card on a copy stream (``non_blocking``); the compute
  stream waits on the copy's event before the op runs, and the device tensors
  are marked used by the compute stream (``record_stream``), so the caching
  allocator never hands their memory out while the op may still read them;
* the one blocking point is the readback of the previous chunk, made after
  the next chunk's copy has been queued.  Planes are read back into fresh
  host arrays (a sink may keep them); per-frame props stay on the card until
  then and are copied once per chunk.

On the CPU (``device="cpu"``) the same loop runs with plain copies.
``donate=True`` releases the chunk's input tensors as soon as its op has
run.  ``mesh`` (sharding a chunk over several devices) is not ported: a call
with ``mesh`` set raises.

``STATS`` holds the last call's host time spent filling the staging buffers,
the bytes sent to the device and, on the card, CUDA events around each
chunk's copy and op (read them after ``torch.cuda.synchronize()``).
"""

from __future__ import annotations

import time
import warnings
from typing import Callable, Sequence

import numpy as np
import torch

from ..core.clip import Clip
from ..core.format import VideoFormat
from ..core.params import VSZipError

STATS: dict = {}


class ArraySource:
    """FrameSource over in-memory (or memory-mapped) per-plane arrays."""

    def __init__(self, planes: Sequence[np.ndarray], fmt: VideoFormat,
                 props: dict | None = None):
        self.planes = tuple(planes)
        self.format = fmt
        self.props = dict(props or {})
        self.num_frames = self.planes[0].shape[0]

    def __call__(self, start: int, stop: int):
        return tuple(p[start:stop] for p in self.planes)


class SyntheticSource:
    """FrameSource that fabricates frames on demand (benchmarks: a
    5000-frame workload does not fit host RAM either)."""

    def __init__(self, make: Callable[[int, int], tuple], fmt: VideoFormat,
                 num_frames: int, props: dict | None = None):
        self._make = make
        self.format = fmt
        self.props = dict(props or {})
        self.num_frames = num_frames

    def __call__(self, start: int, stop: int):
        return self._make(start, stop)


def _host_tensor(p) -> torch.Tensor:
    """A CPU tensor viewing the host array `p` (only read; a read-only or
    memory-mapped array too), so that torch's multi-threaded copy fills the
    staging buffers."""
    a = np.asarray(p)
    if any(st < 0 for st in a.strides):
        a = np.ascontiguousarray(a)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        return torch.from_numpy(a)


def _fill(view: torch.Tensor, p) -> None:
    """Copy the host frames `p` into the pinned staging view `view` with
    torch's multi-threaded copy (a median 61 ms against 176 for a
    single-threaded ``np.copyto`` on the 192-frame 1080p row, H100 host;
    ``tools/stream_fill.py`` swaps this function to time the two)."""
    src = _host_tensor(p)
    if src.dtype != view.dtype:
        raise TypeError(f"process_stream: the source gave {src.dtype} frames for "
                        f"{view.dtype} planes")
    view.copy_(src)


def _trim(arr, lead: int, tail: int):
    n = arr.shape[0]
    return arr[lead: n - tail if tail else n]


class _Loader:
    """Puts chunks of `source` on `device`: through a ring of two pinned
    staging buffers and a copy stream on the card, by plain copies on the
    CPU."""

    def __init__(self, source, device: torch.device, max_frames: int):
        self.source = source
        self.device = device
        self.cuda = device.type == "cuda"
        self.max_frames = max_frames
        self.ring = None
        self.done = [None, None]
        self.count = 0
        if self.cuda:
            self.copy_stream = torch.cuda.Stream(device)

    def _staging(self, host):
        """The ring's two sets of pinned buffers, one per plane, allocated at
        the first chunk's plane shapes with room for the largest chunk."""
        dtype = self.source.format.torch_dtype
        return [[torch.empty((self.max_frames,) + tuple(p.shape[1:]), dtype=dtype,
                             pin_memory=True) for p in host] for _ in range(2)]

    def load(self, lo: int, hi: int):
        """The chunk [lo, hi) on the device, as a tuple of plane tensors, and
        (on the card) the event its copy records."""
        host = self.source(lo, hi)
        t0 = time.perf_counter()
        if not self.cuda:
            planes = tuple(_host_tensor(p).clone() for p in host)
            STATS["fill_s"] += time.perf_counter() - t0
            STATS["h2d_bytes"] += sum(p.nbytes for p in host)
            return planes, None
        if self.ring is None:
            self.ring = self._staging(host)
        slot = self.count % 2
        self.count += 1
        if self.done[slot] is not None:
            self.done[slot].synchronize()  # the buffer's last copy has read it
        staged = []
        for buf, p in zip(self.ring[slot], host):
            view = buf[: hi - lo]
            _fill(view, p)
            staged.append(view)
        STATS["fill_s"] += time.perf_counter() - t0
        STATS["h2d_bytes"] += sum(v.numel() * v.element_size() for v in staged)
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self.copy_stream):
            start.record(self.copy_stream)
            planes = tuple(v.to(self.device, non_blocking=True) for v in staged)
            done.record(self.copy_stream)
        self.done[slot] = done
        STATS["copies"].append((start, done))
        return planes, done


def process_stream(source, op, *, batch: int = 32, overlap: int = 0,
                   sink: Callable[[int, Clip], None] | None = None,
                   donate: bool = True, mesh=None, device="cuda") -> dict:
    """Stream ``source`` through ``op`` in ``batch``-frame chunks.

    source: ``ArraySource``/``SyntheticSource`` or any object with
        ``num_frames``, ``format``, ``props`` and ``(start, stop) ->
        tuple[np.ndarray per plane]``.
    op: a ``Clip -> Clip`` function, run on each chunk on `device`.
    overlap: temporal halo fed to each chunk on both sides and trimmed
        from its outputs (set to the op's temporal radius).
    sink: called as ``sink(frame_index, chunk_clip_numpy)`` for every
        output chunk, in output-frame units; its planes are fresh NumPy
        arrays and its props host copies (per-frame ones trimmed like the
        planes), without the streaming-internal props.  When None, plane
        data is dropped and only per-frame props (metrics) are accumulated.
    donate: release each chunk's input tensors once its op has run.
    mesh: not ported (multi-device sharding); must be None.
    device: where the op runs, ``"cuda"`` (default) or ``"cpu"``.

    Returns a dict of accumulated per-frame props (each a (num_frames, ...)
    NumPy array for array-valued props, else the last scalar value).
    """
    n = int(source.num_frames)
    fmt = source.format
    if n <= 0:
        raise VSZipError("process_stream: empty source.")
    if batch <= 0 or overlap < 0:
        raise VSZipError("process_stream: batch must be > 0, overlap >= 0.")
    if mesh is not None:
        raise VSZipError(
            "process_stream: mesh is not supported by the PyTorch port yet "
            "(multi-device sharding is not ported); pass mesh=None.")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "process_stream: device='cuda' but no CUDA device is available; "
            "pass device='cpu' to stream on the CPU.")

    STATS.clear()
    STATS.update(fill_s=0.0, h2d_bytes=0, copies=[], computes=[])
    starts = list(range(0, n, batch))
    loader = _Loader(source, dev, min(n, batch + 2 * overlap))
    compute = torch.cuda.current_stream(dev) if loader.cuda else None
    prop_chunks: dict[str, list] = {}
    prop_scalars: dict[str, object] = {}

    def load(start: int):
        """The chunk [start-overlap, start+batch+overlap) on the device."""
        lo = max(0, start - overlap)
        hi = min(n, start + batch + overlap)
        planes, event = loader.load(lo, hi)
        return (Clip(planes, fmt, dict(source.props)), start - lo,
                hi - min(n, start + batch), event)

    pending = None   # (start, out_clip, lead, tail) awaiting readback
    nxt = load(starts[0])
    for idx, start in enumerate(starts):
        clip, lead, tail, event = nxt
        nxt = None
        in_frames = clip.planes[0].shape[0]
        if loader.cuda:
            compute.wait_event(event)
            for p in clip.planes:
                p.record_stream(compute)
            began = torch.cuda.Event(enable_timing=True)
            ended = torch.cuda.Event(enable_timing=True)
            began.record(compute)
        out = op(clip)
        if loader.cuda:
            ended.record(compute)
            STATS["computes"].append((began, ended))
        if donate:
            del clip
        out_frames = out.planes[0].shape[0]
        m = 1
        if out_frames != in_frames:
            # frame-count-changing ops (EEDI3/EEDI3H field=2/3 double the
            # rate: input frame i -> output frames m*i .. m*i+m-1, a
            # contiguous run, so halo trimming scales by m).  Non-multiple
            # changes (trims, arbitrary selectors) can't be chunk-trimmed.
            if out_frames % in_frames:
                raise VSZipError(
                    "process_stream: op changed the chunk frame count "
                    f"{in_frames} -> {out_frames} (not an integer "
                    "multiple); this op cannot be streamed in chunks.")
            m = out_frames // in_frames
            lead, tail = m * lead, m * tail
        if idx + 1 < len(starts):
            nxt = load(starts[idx + 1])      # H2D overlaps the compute
        if pending is not None:
            _drain(pending, sink, prop_chunks, prop_scalars)
        # sink indices are in OUTPUT-frame units: frame-multiplying ops
        # place source chunk [start, start+batch) at m*start in the output.
        pending = (m * start, out, lead, tail)
        del out
    _drain(pending, sink, prop_chunks, prop_scalars)
    del pending

    props: dict = dict(prop_scalars)
    for k, chunks in prop_chunks.items():
        props[k] = np.concatenate(chunks)
    _finalize_aggregates(props, dev)
    return props


def _finalize_aggregates(props: dict, device: torch.device) -> None:
    """Recompute end-of-run aggregate props from accumulated per-frame
    state.  Scalar props otherwise keep the LAST chunk's value, which for
    metrics whose aggregate spans all frames (XPSNR's average — reference
    src/vapoursynth/xpsnr.zig:89-96,114-128) would silently report only the
    final chunk.  Ops opt in by attaching an ``_<OP>_AggMeta`` scalar prop
    plus whatever per-frame arrays their finalizer needs; the recompute runs
    the op's own aggregate math on the stream's device, so a streamed run
    equals a resident one."""
    if "_XPSNR_WSSE" in props:
        from ..ops.xpsnr import _prop_math

        wsse = props.pop("_XPSNR_WSSE")
        num64 = props.pop("_XPSNR_Num64")
        _, avg = _prop_math(torch.from_numpy(wsse).to(device),
                            torch.from_numpy(np.asarray(num64)).to(device))
        props["XPSNR_AVG"] = avg.cpu().numpy()


# props that are constant metadata for the aggregate finalizers: never
# per-frame even if their length happens to match a chunk's frame count
_SCALAR_PROPS = frozenset({"_XPSNR_Num64"})

# internal streaming-support props consumed by _finalize_aggregates; they
# are stripped from the clips handed to sinks (sinks see only the
# reference's public prop surface)
_INTERNAL_PROPS = frozenset({"_XPSNR_WSSE", "_XPSNR_Num64"})


def _host(v):
    """A prop value as a host NumPy array (tensors copied), else as is."""
    if isinstance(v, torch.Tensor):
        return v.cpu().numpy()
    return np.asarray(v) if hasattr(v, "shape") else v


def _drain(pending, sink, prop_chunks, prop_scalars):
    """Read back one chunk: its planes (when a sink takes them) into fresh
    host arrays, its per-frame props trimmed of the halo."""
    start, out, lead, tail = pending
    frames = out.planes[0].shape[0]
    host_planes = tuple(_trim(p, lead, tail).to("cpu", copy=True).numpy()
                        for p in out.planes) if sink is not None else None
    sink_props = {}
    for k, v in out.props.items():
        if k not in _SCALAR_PROPS and hasattr(v, "shape") \
                and getattr(v, "ndim", 0) >= 1 and v.shape[0] == frames:
            h = _host(_trim(v, lead, tail))
            prop_chunks.setdefault(k, []).append(h)
        else:
            h = _host(v)
            prop_scalars[k] = h
        if k not in _INTERNAL_PROPS:
            sink_props[k] = h
    if sink is not None:
        sink(start, Clip(host_planes, out.format, sink_props))
