"""Clip: a batch of planar video frames as PyTorch tensors.

The same model as ``vszip_tpu.core.clip``: a clip holds one ``(N, H, W)``
tensor per plane (N = frames) plus a constant format and a props dict.
Subsampled chroma planes are separate tensors, since 4:2:0 planes are ragged.
``from_planes`` and ``blank`` put the planes on the card unless the caller
asks for another device (``device="cpu"``); without a card they raise
torch's own error rather than stay on the CPU.  ``to(device)`` moves a clip,
and every op runs on the device its input planes lie on.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from .format import ColorFamily, ColorRange, SampleType, VideoFormat, get_format
from .params import VSZipError


def _as_tensor(arr) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:  # e.g. a view of a JAX array's buffer
        arr = arr.copy()
    return torch.from_numpy(arr)


@dataclasses.dataclass
class Clip:
    """Batched planar video clip.

    planes: tuple of tensors, one per plane, each (num_frames, h, w) in the
        format's ``torch_dtype``, all on one device.
    format: constant VideoFormat.
    props: per-clip/per-frame properties (metric outputs, color range, ...).
        Values may be tensors of shape (num_frames,) or plain scalars.
    """

    planes: tuple
    format: VideoFormat
    props: dict = dataclasses.field(default_factory=dict)

    # -- constructors ---------------------------------------------------------

    @classmethod
    def from_planes(cls, planes, fmt: VideoFormat, props: Mapping[str, Any] | None = None,
                    *, device: torch.device | str = "cuda") -> "Clip":
        """Clip from tensors or NumPy arrays, every plane on `device`."""
        planes = tuple(_as_tensor(p) for p in planes)
        if len(planes) != fmt.num_planes:
            raise ValueError(
                f"{fmt.name} needs {fmt.num_planes} planes, got {len(planes)}"
            )
        w, h = planes[0].shape[2], planes[0].shape[1]
        for p, arr in enumerate(planes):
            if arr.ndim != 3:
                raise ValueError(f"plane {p} must be (N, H, W), got {tuple(arr.shape)}")
            pw, ph = fmt.plane_dims(w, h, p)
            if tuple(arr.shape[1:]) != (ph, pw):
                raise ValueError(
                    f"plane {p} shape {tuple(arr.shape[1:])} != expected {(ph, pw)}"
                )
            if arr.dtype != fmt.torch_dtype:
                raise ValueError(
                    f"plane {p} dtype {arr.dtype} != {fmt.torch_dtype} for {fmt.name}"
                )
        return cls(tuple(p.to(device) for p in planes), fmt, dict(props or {}))

    @classmethod
    def blank(cls, fmt: VideoFormat, width: int, height: int, num_frames: int = 1,
              value=None, device: torch.device | str = "cuda") -> "Clip":
        """BlankClip equivalent: neutral gray unless `value` given."""
        planes = []
        for p in range(fmt.num_planes):
            pw, ph = fmt.plane_dims(width, height, p)
            if value is not None:
                v = value[p] if isinstance(value, (list, tuple)) else value
            elif fmt.sample_type is SampleType.FLOAT:
                v = 0.0
            else:
                chroma = fmt.color_family is ColorFamily.YUV and p > 0
                v = (1 << (fmt.bits_per_sample - 1)) if chroma else 0
            planes.append(torch.full((num_frames, ph, pw), v,
                                     dtype=fmt.torch_dtype, device=device))
        return cls.from_planes(planes, fmt, device=device)

    # -- accessors -------------------------------------------------------------

    @property
    def num_planes(self) -> int:
        return len(self.planes)

    @property
    def num_frames(self) -> int:
        return int(self.planes[0].shape[0])

    @property
    def width(self) -> int:
        return int(self.planes[0].shape[2])

    @property
    def height(self) -> int:
        return int(self.planes[0].shape[1])

    def plane_dims(self, plane: int) -> tuple[int, int]:
        return self.format.plane_dims(self.width, self.height, plane)

    def color_range(self) -> ColorRange:
        """Frame-prop probe with the reference's fallback rule
        (RGB -> FULL, else LIMITED; reference src/helper.zig:261-279)."""
        cr = self.props.get("_ColorRange")
        if cr is not None:
            first = (cr.reshape(-1)[0].item() if isinstance(cr, torch.Tensor)
                     else np.asarray(cr).reshape(-1)[0])
            return ColorRange.FULL if int(first) == 0 else ColorRange.LIMITED
        return (
            ColorRange.FULL
            if self.format.color_family is ColorFamily.RGB
            else ColorRange.LIMITED
        )

    def with_planes(self, planes, fmt: VideoFormat | None = None) -> "Clip":
        return Clip(tuple(planes), fmt or self.format, dict(self.props))

    def with_props(self, **props) -> "Clip":
        d = dict(self.props)
        d.update(props)
        return Clip(self.planes, self.format, d)

    def numpy(self) -> "Clip":
        """The same clip with its planes copied to host NumPy arrays."""
        return Clip(tuple(p.cpu().numpy() for p in self.planes), self.format,
                    dict(self.props))

    def to(self, device: torch.device | str) -> "Clip":
        """The same clip with its planes and tensor props on `device`."""
        props = {k: v.to(device) if isinstance(v, torch.Tensor) else v
                 for k, v in self.props.items()}
        return Clip(tuple(p.to(device) for p in self.planes), self.format, props)

    def frame(self, n: int) -> "Clip":
        """Single-frame view (length-1 clip) of frame n."""
        return Clip(
            tuple(p[n : n + 1] for p in self.planes), self.format, dict(self.props)
        )


def from_reference(planes, format_name: str, props: Mapping[str, Any] | None = None,
                   *, device: torch.device | str) -> Clip:
    """Build a Clip on `device` from a JAX clip's state as NumPy arrays:
    ``planes`` are ``np.asarray(p)`` of ``vszip_tpu.Clip.planes`` and
    ``props`` its props (arrays become tensors, scalars stay as they are).
    The clip and its props are the whole state of the ported ops."""
    fmt = get_format(format_name)
    tensors = tuple(_as_tensor(p) for p in planes)
    conv = {k: _as_tensor(v).to(device) if isinstance(v, np.ndarray) else v
            for k, v in (props or {}).items()}
    return Clip.from_planes(tensors, fmt, conv, device=device)


def _reject_variable_format():
    """The reference host runtime's error for a variable-format clip piped
    into a filter (it rejects such input at filter Create time)."""
    raise VSZipError(
        "clip must have constant format and dimensions: this is a "
        "variable-format clip (RFS mismatch output); process per frame "
        "via get_frame(n) instead."
    )


class _WipedFormat:
    """Sentinel for a wiped (variable) format: falsy, and any attribute
    access raises the host runtime's constant-format error so filters fail
    clearly instead of with an opaque AttributeError."""

    def __bool__(self):
        return False

    def __repr__(self):
        return "<variable format>"

    def __getattr__(self, name):
        _reject_variable_format()


WIPED_FORMAT = _WipedFormat()


class VariableClip:
    """Variable-format clip: per-frame references into heterogeneous sources.

    The reference's RFS ``mismatch=True`` wipes width/height/format on the
    output VideoInfo and serves each frame wholesale from clip a or b
    (reference src/vapoursynth/rfs.zig:150-188 + the getFrame passthrough
    :18-29).  Batched plane tensors can't hold ragged frames, so this is a
    lazy union: ``get_frame(n)`` materializes a single-frame Clip from
    whichever source owns frame n.  Dimensions report 0 and format the falsy
    WIPED_FORMAT sentinel when the sources disagree, mirroring the wiped
    VideoInfo; piping the clip into any filter raises the host runtime's
    constant-format error (see _WipedFormat / the .planes guard below).
    """

    def __init__(self, sources, table):
        """sources: sequence of Clip; table: per-frame (source_idx, frame_idx)."""
        self.sources = tuple(sources)
        self.table = tuple((int(s), int(f)) for s, f in table)

    @property
    def num_frames(self) -> int:
        return len(self.table)

    def _common(self, getter, wipe):
        vals = {getter(s) for s in self.sources}
        return vals.pop() if len(vals) == 1 else wipe

    @property
    def width(self) -> int:
        return self._common(lambda s: s.width, 0)

    @property
    def height(self) -> int:
        return self._common(lambda s: s.height, 0)

    @property
    def format(self):
        return self._common(lambda s: s.format, WIPED_FORMAT)

    def get_frame(self, n: int) -> Clip:
        src_idx, frame_idx = self.table[n]
        return self.sources[src_idx].frame(frame_idx)

    # -- filter-input guard ----------------------------------------------
    # Ops consume clips through .planes (and friends); raise the clear
    # constant-format error instead of an opaque AttributeError.

    @property
    def planes(self):
        _reject_variable_format()

    @property
    def num_planes(self):
        _reject_variable_format()

    @property
    def props(self):
        _reject_variable_format()

    def plane_dims(self, plane: int):
        _reject_variable_format()
