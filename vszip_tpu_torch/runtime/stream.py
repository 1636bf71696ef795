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
run.

With ``mesh`` (``parallel.frames_mesh``) a chunk whose frame count, halo
included, divides the mesh is split into equal spans, one per mesh entry;
each entry's device gets its span plus ``overlap`` frames of the chunk on
either side, by its own copy stream from the one pinned ring, runs the op and
trims that halo, and the spans are put back together on the mesh's first
device (``parallel.mesh.gather``) before the chunk is read back as above.  A
chunk that does not divide (the tail) runs whole on the first device.  As in
the JAX package, the result is the same either way.

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
from ..trace import span

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
    """Puts chunks of `source` on the mesh's devices (`devices`, one entry
    per shard; a device may repeat): through a ring of two pinned staging
    buffers and one copy stream per entry on the card, by plain copies on
    the CPU."""

    def __init__(self, source, devices: tuple, max_frames: int):
        self.source = source
        self.devices = devices
        self.cuda = devices[0].type == "cuda"
        self.max_frames = max_frames
        self.ring = None
        self.done = [[], []]
        self.count = 0
        if self.cuda:
            self.copy_streams = [torch.cuda.Stream(d) for d in devices]

    def _staging(self, host):
        """The ring's two sets of pinned buffers, one per plane, allocated at
        the first chunk's plane shapes with room for the largest chunk."""
        dtype = self.source.format.torch_dtype
        return [[torch.empty((self.max_frames,) + tuple(p.shape[1:]), dtype=dtype,
                             pin_memory=True) for p in host] for _ in range(2)]

    def load(self, lo: int, hi: int, parts: list):
        """The chunk [lo, hi) as `parts`, (mesh entry, start, stop) ranges of
        its frames: for each part its plane tensors on the entry's device and
        (on the card) the event its copy records."""
        with span("vszip.stream.source"):
            host = self.source(lo, hi)
        if not self.cuda:
            with span("vszip.stream.fill"):
                t0 = time.perf_counter()
                src = [_host_tensor(p) for p in host]
                loaded = [(tuple(t[a:b].clone() for t in src), None) for _, a, b in parts]
                STATS["fill_s"] += time.perf_counter() - t0
            STATS["h2d_bytes"] += sum(t[a:b].nbytes for _, a, b in parts for t in src)
            return loaded
        with span("vszip.stream.fill"):
            t0 = time.perf_counter()
            if self.ring is None:
                self.ring = self._staging(host)
            slot = self.count % 2
            self.count += 1
            with span("vszip.stream.wait"):
                for done in self.done[slot]:
                    done.synchronize()  # the buffer's last copies have read it
            staged = []
            for buf, p in zip(self.ring[slot], host):
                view = buf[: hi - lo]
                _fill(view, p)
                staged.append(view)
            STATS["fill_s"] += time.perf_counter() - t0
        loaded, self.done[slot] = [], []
        for entry, a, b in parts:
            stream = self.copy_streams[entry]
            start = torch.cuda.Event(enable_timing=True)
            done = torch.cuda.Event(enable_timing=True)
            with span("vszip.stream.copy"), torch.cuda.stream(stream):
                start.record(stream)
                planes = tuple(v[a:b].to(self.devices[entry], non_blocking=True)
                               for v in staged)
                done.record(stream)
            STATS["h2d_bytes"] += sum(t.numel() * t.element_size() for t in planes)
            STATS["copies"].append((start, done))
            self.done[slot].append(done)
            loaded.append((planes, done))
        return loaded


def process_stream(source, op, *, batch: int = 32, overlap: int = 0,
                   sink: Callable[[int, Clip], None] | None = None,
                   donate: bool = True, mesh=None, device=None) -> dict:
    """Stream ``source`` through ``op`` in ``batch``-frame chunks.

    source: ``ArraySource``/``SyntheticSource`` or any object with
        ``num_frames``, ``format``, ``props`` and ``(start, stop) ->
        tuple[np.ndarray per plane]``.
    op: a ``Clip -> Clip`` function, run on each chunk (or span of a chunk)
        on the device its planes lie on.
    overlap: temporal halo fed to each chunk on both sides and trimmed
        from its outputs (set to the op's temporal radius); over a mesh,
        each span of a chunk gets the same halo.
    sink: called as ``sink(frame_index, chunk_clip_numpy)`` for every
        output chunk, in output-frame units; its planes are fresh NumPy
        arrays and its props host copies (per-frame ones trimmed like the
        planes), without the streaming-internal props.  When None, plane
        data is dropped and only per-frame props (metrics) are accumulated.
    donate: release each chunk's input tensors once its op has run.
    mesh: optional ``parallel.frames_mesh(...)``: chunks whose frame count
        (halo included) divides the mesh are split over its devices, the
        others run on its first device; the result is the same either way.
    device: where the op runs without a mesh, ``"cuda"`` (default) or
        ``"cpu"``; with a mesh, leave it out (the mesh names the devices).

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
        from ..parallel import mesh as pm

        if not isinstance(mesh, pm.Mesh):
            raise VSZipError("process_stream: mesh must be a parallel.frames_mesh(...) "
                             f"mesh, not {type(mesh).__name__}.")
        if device is not None:
            raise VSZipError("process_stream: pass device or mesh, not both (a mesh names "
                             "its devices).")
        if len({d.type for d in mesh.devices}) != 1:
            raise VSZipError("process_stream: a mesh's devices must be all CUDA devices "
                             "or all the CPU.")
        devices = mesh.devices
    else:
        devices = (torch.device("cuda" if device is None else device),)
    if devices[0].type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "process_stream: device='cuda' but no CUDA device is available; "
            "pass device='cpu' to stream on the CPU.")

    STATS.clear()
    STATS.update(fill_s=0.0, h2d_bytes=0, copies=[], computes=[])
    starts = list(range(0, n, batch))
    loader = _Loader(source, devices, min(n, batch + 2 * overlap))
    prop_chunks: dict[str, list] = {}
    prop_scalars: dict[str, object] = {}

    def load(start: int):
        """The chunk [start-overlap, start+batch+overlap) on the devices, as
        (mesh entry, planes, copy event, halo frames before, after) per span."""
        lo = max(0, start - overlap)
        hi = min(n, start + batch + overlap)
        k = len(devices)
        if k > 1 and (hi - lo) % k == 0:
            span = (hi - lo) // k
            cores = [(e * span, (e + 1) * span) for e in range(k)]
            parts = [(e, max(0, a - overlap), min(hi - lo, b + overlap))
                     for e, (a, b) in enumerate(cores)]
        else:
            cores = [(0, hi - lo)]
            parts = [(0, 0, hi - lo)]
        loaded = loader.load(lo, hi, parts)
        spans = [(e, planes, event, a - pa, pb - b)
                 for (e, pa, pb), (a, b), (planes, event) in zip(parts, cores, loaded)]
        return spans, hi - lo, start - lo, hi - min(n, start + batch)

    pending = None   # (start, out_clip, lead, tail) awaiting readback
    nxt = load(starts[0])
    for idx, start in enumerate(starts):
        spans, in_frames, lead, tail = nxt
        nxt = None
        pieces = []
        for entry, planes, event, before, after in spans:
            clip = Clip(planes, fmt, dict(source.props))
            if loader.cuda:
                compute = torch.cuda.current_stream(devices[entry])
                compute.wait_event(event)
                for p in planes:
                    p.record_stream(compute)
                began = torch.cuda.Event(enable_timing=True)
                ended = torch.cuda.Event(enable_timing=True)
                began.record(compute)
            with span("vszip.stream.op"):
                out = op(clip)
            if loader.cuda:
                ended.record(compute)
                STATS["computes"].append((began, ended))
            if donate:
                del clip
            pieces.append((out, before, after, planes[0].shape[0]))
            del planes, out
        del spans
        if len(pieces) == 1:
            out = pieces[0][0]
        else:
            with span("vszip.stream.gather"):
                out = pm.gather(pieces, devices[0], "process_stream")
        del pieces
        # frame-count-changing ops (EEDI3/EEDI3H field=2/3 double the rate:
        # input frame i -> output frames m*i .. m*i+m-1, a contiguous run,
        # so halo trimming scales by m)
        m = _multiplier(in_frames, out.planes[0].shape[0], "process_stream")
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
    _finalize_aggregates(props, devices[0])
    return props


def _multiplier(in_frames: int, out_frames: int, who: str) -> int:
    """How many output frames an op gave per input frame: 1, or the integer
    multiple of a frame-count-changing op.  Non-multiple changes (trims,
    arbitrary selectors) can't be chunk-trimmed."""
    if out_frames % in_frames:
        raise VSZipError(
            f"{who}: op changed the chunk frame count "
            f"{in_frames} -> {out_frames} (not an integer "
            "multiple); this op cannot be streamed in chunks.")
    return out_frames // in_frames


def aggregates(props: dict) -> dict:
    """End-of-run aggregate props recomputed from accumulated per-frame
    state (tensors), on the state's device.  Scalar props otherwise keep the
    LAST chunk's (or span's) value, which for metrics whose aggregate spans
    all frames (XPSNR's average — reference
    src/vapoursynth/xpsnr.zig:89-96,114-128) would silently report only the
    final chunk.  Ops opt in by attaching an ``_<OP>_AggMeta`` scalar prop
    plus whatever per-frame arrays their finalizer needs; the recompute runs
    the op's own aggregate math, so a streamed or sharded run equals a
    resident one.  Shared by ``process_stream`` and ``parallel.run_sharded``."""
    if "_XPSNR_WSSE" in props:
        from ..ops.xpsnr import _prop_math

        _, avg = _prop_math(props["_XPSNR_WSSE"], props["_XPSNR_Num64"])
        return {"XPSNR_AVG": avg}
    return {}


def _finalize_aggregates(props: dict, device: torch.device) -> None:
    """Replace a stream's accumulated aggregate state (host arrays) by the
    aggregates (``aggregates``, run on the stream's device), as host arrays."""
    state = {k: torch.from_numpy(np.asarray(props.pop(k))).to(device)
             for k in _INTERNAL_PROPS if k in props}
    props.update({k: v.cpu().numpy() for k, v in aggregates(state).items()})


# props that are constant metadata for the aggregate finalizers: never
# per-frame even if their length happens to match a chunk's frame count
_SCALAR_PROPS = frozenset({"_XPSNR_Num64"})

# internal streaming-support props consumed by _finalize_aggregates; they
# are stripped from the clips handed to sinks (sinks see only the
# reference's public prop surface)
_INTERNAL_PROPS = frozenset({"_XPSNR_WSSE", "_XPSNR_Num64"})


def per_frame(key: str, value, frames: int) -> bool:
    """Whether prop `key` holds one entry per frame of a `frames`-frame
    clip (an array or tensor whose first axis is the frames), as opposed to
    a per-clip value."""
    return (key not in _SCALAR_PROPS and hasattr(value, "shape")
            and getattr(value, "ndim", 0) >= 1 and value.shape[0] == frames)


def trim(clip: Clip, lead: int, tail: int) -> Clip:
    """`clip` without its first `lead` and last `tail` frames, per-frame
    props trimmed alike (views; nothing is copied)."""
    frames = clip.planes[0].shape[0]
    props = {k: _trim(v, lead, tail) if per_frame(k, v, frames) else v
             for k, v in clip.props.items()}
    return Clip(tuple(_trim(p, lead, tail) for p in clip.planes), clip.format, props)


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
    kept = trim(out, lead, tail)
    with span("vszip.stream.readback"):
        host_planes = tuple(p.to("cpu", copy=True).numpy()
                            for p in kept.planes) if sink is not None else None
        sink_props = {}
        for k, v in kept.props.items():
            h = _host(v)
            if per_frame(k, out.props[k], frames):
                prop_chunks.setdefault(k, []).append(h)
            else:
                prop_scalars[k] = h
            if k not in _INTERNAL_PROPS:
                sink_props[k] = h
    if sink is not None:
        with span("vszip.stream.sink"):
            sink(start, Clip(host_planes, out.format, sink_props))
