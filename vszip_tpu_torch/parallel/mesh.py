"""Frame sharding: split a clip's frames over several devices.

The PyTorch counterpart of ``vszip_tpu.parallel.mesh``.  The reference's
only parallelism is frame-level task parallelism on the VS thread pool plus
SIMD lanes (SURVEY §2.3); here, as in the JAX package, the unit is a 1-D
``frames`` mesh: every filter is embarrassingly parallel over the leading
(N, H, W) batch axis, metric filters reduce over frames, and temporal
filters (Checkmate, XPSNR's temporal terms, CombMask's motion) read a few
neighbouring frames.

Where this differs from the JAX package: the JAX mesh is SPMD under a single
controller, so ops run unchanged on a frames-sharded array and XLA inserts
the cross-shard frame reads and the reductions.  Nothing inserts collectives
around this port's hand-written kernels, so the sharding is explicit and in
one process.  ``run_sharded`` gives each device its span of frames plus a
halo of ``overlap`` frames on each side, taken from the neighbouring spans
(clipped to the clip), runs the op there, trims the halo, and puts the spans
back together; the end-of-run aggregates (XPSNR's average) are recomputed
over all frames by the streaming runtime's ``aggregates``.  With ``overlap``
at least the op's temporal radius the result equals the unsharded call.
Devices are dispatched one after another; launches are asynchronous, so
their work overlaps.  ``process_stream(mesh=...)`` splits its chunks the
same way.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..core.clip import Clip
from ..core.params import VSZipError
from ..runtime.stream import _multiplier, aggregates, per_frame, trim

FRAMES_AXIS = "frames"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the devices along the ``frames`` axis, in order.  A
    device may appear more than once (several shards on one device)."""

    devices: tuple

    axis_names = (FRAMES_AXIS,)

    @property
    def size(self) -> int:
        return len(self.devices)


def frames_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over `n_devices` CUDA devices (default: all visible ones),
    or over `devices` exactly as given, repeats included.

    Raises if fewer than `n_devices` CUDA devices are visible: a silently
    truncated mesh would let multi-device tests "pass" on one device.
    """
    if devices is None:
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        want = visible if n_devices is None else n_devices
        if want <= 0 or visible < want:
            raise RuntimeError(
                f"frames_mesh: requested {want if n_devices is not None else 'all'} CUDA "
                f"device(s) but {visible} visible; to run several shards on fewer devices "
                f"name them, e.g. frames_mesh(devices=['cuda:0'] * 2) or "
                f"devices=['cpu'] * 8")
        devices = [torch.device("cuda", i) for i in range(want)]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise VSZipError("frames_mesh: no devices given.")
    return Mesh(devices)


def _spans(n: int, k: int, who: str) -> list[tuple[int, int]]:
    """The k equal frame spans of an n-frame clip (k must divide n)."""
    if n % k:
        raise VSZipError(f"{who}: {n} frames do not divide over a mesh of {k} devices.")
    s = n // k
    return [(i * s, (i + 1) * s) for i in range(k)]


def _to(v, device):
    return v.to(device) if isinstance(v, torch.Tensor) else v


def _frames(clip: Clip, lo: int, hi: int, device) -> Clip:
    """Frames [lo, hi) of `clip` on `device`, per-frame props sliced alike."""
    n = clip.num_frames
    props = {k: _to(v[lo:hi] if per_frame(k, v, n) else v, device)
             for k, v in clip.props.items()}
    return Clip(tuple(p[lo:hi].to(device) for p in clip.planes), clip.format, props)


def shard_clip(clip: Clip, mesh: Mesh) -> tuple[Clip, ...]:
    """The clip split over frames: one clip per mesh entry, holding its
    equal span of frames on its device.  N must divide the mesh."""
    return tuple(_frames(clip, a, b, d)
                 for d, (a, b) in zip(mesh.devices, _spans(clip.num_frames, mesh.size,
                                                          "shard_clip")))


def replicate_clip(clip: Clip, mesh: Mesh) -> tuple[Clip, ...]:
    """The whole clip on every mesh entry's device."""
    return tuple(_frames(clip, 0, clip.num_frames, d) for d in mesh.devices)


def _cat(values: list, device):
    if isinstance(values[0], torch.Tensor):
        return torch.cat([v.to(device) for v in values])
    return np.concatenate(values)


def _state(clips: list, device) -> dict:
    """The per-frame props of consecutive `clips` concatenated on `device`,
    and their other props as the last clip has them."""
    frames = [c.planes[0].shape[0] for c in clips]
    props = {}
    for k, v in clips[-1].props.items():
        if per_frame(k, v, frames[-1]):
            props[k] = _cat([c.props[k] for c in clips], device)
        else:
            props[k] = _to(v, device)
    return props


def _trimmed(pieces, who: str) -> list[Clip]:
    """Each piece ``(out, before, after, in_frames)`` (an op's output on
    `in_frames` input frames, `before` and `after` of them halo) without its
    halo's outputs."""
    kept = []
    for out, before, after, in_frames in pieces:
        m = _multiplier(in_frames, out.planes[0].shape[0], who)
        kept.append(trim(out, m * before, m * after))
    return kept


def gather(pieces, device, who: str) -> Clip:
    """Consecutive spans' outputs (see ``_trimmed``) as one clip on `device`:
    planes and per-frame props concatenated, aggregates recomputed."""
    kept = _trimmed(pieces, who)
    props = _state(kept, device)
    props.update(aggregates(props))
    planes = tuple(torch.cat([c.planes[p].to(device) for c in kept])
                   for p in range(len(kept[0].planes)))
    return Clip(planes, kept[0].format, props)


def run_sharded(op: Callable[..., Clip], *clips: Clip, mesh: Mesh, overlap: int = 0,
                per_device: bool = False):
    """``op(*clips)`` with the frames split over `mesh`.

    Each mesh entry's device gets its equal span of every clip's frames plus
    `overlap` frames on each side from the neighbouring spans (clipped to
    the clip), runs `op` on them there and trims the halo's outputs.  The
    spans are concatenated on the mesh's first device into one clip, or,
    with `per_device`, returned as a tuple of one clip per entry, each on
    its device.  Per-frame props are concatenated (or trimmed per span), other
    props are the last span's, and the end-of-run aggregates (XPSNR's
    average) are recomputed over all frames.  With `overlap` at least the
    op's temporal radius the result equals ``op(*clips)`` bit for bit.  The
    clips' frame count must divide the mesh.
    """
    if not clips:
        raise VSZipError("run_sharded: no clips given.")
    n = clips[0].num_frames
    if any(c.num_frames != n for c in clips):
        raise VSZipError("run_sharded: the clips' frame counts differ.")
    if overlap < 0:
        raise VSZipError("run_sharded: overlap must be >= 0.")
    pieces = []
    for d, (a, b) in zip(mesh.devices, _spans(n, mesh.size, "run_sharded")):
        lo, hi = max(0, a - overlap), min(n, b + overlap)
        pieces.append((op(*(_frames(c, lo, hi, d) for c in clips)), a - lo, hi - b, hi - lo))
    if not per_device:
        return gather(pieces, mesh.devices[0], "run_sharded")
    kept = _trimmed(pieces, "run_sharded")
    agg = aggregates(_state(kept, mesh.devices[0]))
    return tuple(c.with_props(**{k: _to(v, c.planes[0].device) for k, v in agg.items()})
                 for c in kept)
