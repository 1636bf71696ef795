"""MosquitoNR's smoothing stage: the CUDA wrapper, its plain PyTorch version
and the launch counter.

``mosquito_nr_smooth(x, strength, radius, want_work)`` computes steps 1-3 of
``ops.mosquito_nr._mosquito_plane`` on one (N, H, W) plane: the work plane
(integers lifted to ``x << 4`` in int32, f32 as it is), the 8 directional
SADs over a 2-sample reflect-101 border at radius 1 or 2, the choice (ties
keep the lower index, a zero SAD copies the centre) and the blend.  It
returns the smoothed plane (int32 on the lifted scale, or f32) and, where
`want_work`, the work plane the restore reads (else None).  The JAX package
computes this in plain jnp; no Pallas kernel stands behind it.

The wrapper dispatches on the plane's device: a CPU tensor takes the plain
version (torch ops over whole planes), a CUDA tensor launches
``smooth_kernel`` in ``csrc/mosquito_nr.cu`` once, or raises.  Nothing falls
back.  The kernel computes every integer exactly and rounds every f32 add
and multiply on its own, in the plain version's order (``-fmad=false``), so
the two agree bit for bit on the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build, trace

# Launches made on the CUDA path; the plain version never counts.
LAUNCHES = trace.register_launches({"mosquito_nr_smooth": 0})

_DTYPES = (torch.uint8, torch.uint16, torch.float32)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _pad2(x: torch.Tensor) -> torch.Tensor:
    """2-pixel reflect-101 border on both axes."""
    x = torch.cat([x[:, 1:3].flip(1), x, x[:, -3:-1].flip(1)], dim=1)
    return torch.cat([x[:, :, 1:3].flip(2), x, x[:, :, -3:-1].flip(2)], dim=2)


def _half(a, is_int):
    return (a >> 1) if is_int else a * 0.5


def _sads(t, radius, is_int):
    """Direction per pixel (0-7, or 8 for flat) from the tap view `t(dy, dx)`."""
    c = t(0, 0)

    def A(v):
        return (v - c).abs()

    def H(a, b):
        return (_half(a + b, is_int) - c).abs()

    if radius == 1:
        sad = [
            A(t(0, -1)) + A(t(0, 1)),
            A(t(-1, -1)) + A(t(1, 1)),
            A(t(-1, 0)) + A(t(1, 0)),
            A(t(-1, 1)) + A(t(1, -1)),
            H(t(0, -1), t(-1, -1)) + H(t(0, 1), t(1, 1)),
            H(t(-1, -1), t(-1, 0)) + H(t(1, 1), t(1, 0)),
            H(t(-1, 0), t(-1, 1)) + H(t(1, 0), t(1, -1)),
            H(t(0, 1), t(-1, 1)) + H(t(0, -1), t(1, -1)),
        ]
    else:
        sad = [
            A(t(0, -1)) + A(t(0, 1)) + A(t(0, -2)) + A(t(0, 2)),
            A(t(-1, -1)) + A(t(1, 1)) + A(t(-2, -2)) + A(t(2, 2)),
            A(t(-1, 0)) + A(t(1, 0)) + A(t(-2, 0)) + A(t(2, 0)),
            A(t(-1, 1)) + A(t(1, -1)) + A(t(-2, 2)) + A(t(2, -2)),
            A(t(-1, -2)) + A(t(1, 2)) + H(t(0, -1), t(-1, -1)) + H(t(0, 1), t(1, 1)),
            A(t(-2, -1)) + A(t(2, 1)) + H(t(-1, -1), t(-1, 0)) + H(t(1, 1), t(1, 0)),
            A(t(-2, 1)) + A(t(2, -1)) + H(t(-1, 0), t(-1, 1)) + H(t(1, 0), t(1, -1)),
            A(t(-1, 2)) + A(t(1, -2)) + H(t(-1, 1), t(0, 1)) + H(t(1, -1), t(0, -1)),
        ]
    best = sad[0]
    idx = torch.zeros(c.shape, dtype=torch.int32, device=c.device)
    for i in range(1, 8):
        lt = sad[i] < best
        idx = torch.where(lt, i, idx)
        best = torch.where(lt, sad[i], best)
    return torch.where(best == 0, 8, idx)


def _blend(t, dirs, strength, radius, is_int):
    c = t(0, 0)
    s = strength if is_int else float(np.float32(strength))
    if radius == 1:
        coef0, coef1, coef2 = 64 - 2 * s, 128 - 4 * s, s
        lo_shift, hi_shift = 6, 7
    else:
        coef0, coef1, coef2 = 128 - 4 * s, 256 - 8 * s, s
        coef3 = 2 * s
        lo_shift, hi_shift = 7, 8

    def lo(acc):
        if is_int:
            return (acc + (1 << (lo_shift - 1))) >> lo_shift
        return acc * (1.0 / (1 << lo_shift))

    def hi(acc):
        if is_int:
            return (acc + (1 << (hi_shift - 1))) >> hi_shift
        return acc * (1.0 / (1 << hi_shift))

    if radius == 1:
        arms = [
            lambda: lo(coef0 * c + coef2 * (t(0, -1) + t(0, 1))),
            lambda: lo(coef0 * c + coef2 * (t(-1, -1) + t(1, 1))),
            lambda: lo(coef0 * c + coef2 * (t(-1, 0) + t(1, 0))),
            lambda: lo(coef0 * c + coef2 * (t(-1, 1) + t(1, -1))),
            lambda: hi(coef1 * c + coef2 * (t(-1, -1) + t(0, -1) + t(0, 1) + t(1, 1))),
            lambda: hi(coef1 * c + coef2 * (t(-1, -1) + t(-1, 0) + t(1, 0) + t(1, 1))),
            lambda: hi(coef1 * c + coef2 * (t(-1, 1) + t(-1, 0) + t(1, 0) + t(1, -1))),
            lambda: hi(coef1 * c + coef2 * (t(-1, 1) + t(0, 1) + t(0, -1) + t(1, -1))),
        ]
    else:
        arms = [
            lambda: lo(coef0 * c + coef2 * (t(0, -2) + t(0, -1) + t(0, 1) + t(0, 2))),
            lambda: lo(coef0 * c + coef2 * (t(-2, -2) + t(-1, -1) + t(1, 1) + t(2, 2))),
            lambda: lo(coef0 * c + coef2 * (t(-2, 0) + t(-1, 0) + t(1, 0) + t(2, 0))),
            lambda: lo(coef0 * c + coef2 * (t(-2, 2) + t(-1, 1) + t(1, -1) + t(2, -2))),
            lambda: hi(coef1 * c + coef3 * (t(-1, -2) + t(1, 2))
                       + coef2 * (t(-1, -1) + t(0, -1) + t(0, 1) + t(1, 1))),
            lambda: hi(coef1 * c + coef3 * (t(-2, -1) + t(2, 1))
                       + coef2 * (t(-1, -1) + t(-1, 0) + t(1, 0) + t(1, 1))),
            lambda: hi(coef1 * c + coef3 * (t(-2, 1) + t(2, -1))
                       + coef2 * (t(-1, 1) + t(-1, 0) + t(1, 0) + t(1, -1))),
            lambda: hi(coef1 * c + coef3 * (t(-1, 2) + t(1, -2))
                       + coef2 * (t(-1, 1) + t(0, 1) + t(0, -1) + t(1, -1))),
        ]
    out = c
    for i, arm in enumerate(arms):
        out = torch.where(dirs == i, arm(), out)
    return out


def _smooth(work, strength: int, radius: int, is_int: bool):
    """Steps 2-3 on the work plane; the padded plane and the directions go
    with the stage."""
    h, w = work.shape[1:]
    p = _pad2(work)

    def tap(dy, dx):
        return p[:, 2 + dy:2 + dy + h, 2 + dx:2 + dx + w]

    dirs = _sads(tap, radius, is_int)
    return _blend(tap, dirs, strength, radius, is_int)


def mosquito_nr_smooth_ref(x: torch.Tensor, strength: int, radius: int, want_work: bool):
    """Plain version of ``mosquito_nr_smooth``, on any device."""
    is_int = not x.is_floating_point()
    work = (x.to(torch.int32) << 4) if is_int else x.to(torch.float32)
    return _smooth(work, strength, radius, is_int), (work if want_work else None)


# ---------------------------------------------------------------------------
# entry point (the library is built by ``_build`` at the first launch)
# ---------------------------------------------------------------------------

# src, blur, work (or None), n, h, w, dtype, radius, strength
_SMOOTH = _build.kernel("mosquito_nr", "vz_mosquito_nr_smooth", *[ctypes.c_void_p] * 3,
                        *[ctypes.c_int] * 6)


def _check(x: torch.Tensor, strength: int, radius: int) -> None:
    """Raise unless ``smooth_kernel`` takes `x` and the arguments as they are."""
    if x.device.type != "cuda":
        raise ValueError(f"vszip_tpu_torch: no MosquitoNR kernel for device {x.device}")
    if (x.dtype not in _DTYPES or x.dim() != 3 or not x.is_contiguous()
            or min(x.shape[1:]) < 4):
        raise ValueError("vszip_tpu_torch: mosquito_nr_smooth takes contiguous (N, H, W) uint8, "
                         "uint16 or float32 planes of at least 4x4, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if radius not in (1, 2) or not 0 <= strength <= 32:
        raise ValueError(f"vszip_tpu_torch: mosquito_nr_smooth does not take radius {radius}, "
                         f"strength {strength}")


# ---------------------------------------------------------------------------
# wrapper
# ---------------------------------------------------------------------------

@trace.spanned("vszip.kernel.mosquito_nr_smooth", profiled=False)
def mosquito_nr_smooth(x: torch.Tensor, strength: int, radius: int, want_work: bool):
    """(smoothed plane, work plane or None) of plane `x`: one launch on the
    card, the plain version on the CPU."""
    if x.device.type == "cpu":
        return mosquito_nr_smooth_ref(x, strength, radius, want_work)
    _check(x, strength, radius)
    is_int = not x.is_floating_point()
    blur = torch.empty(x.shape, dtype=torch.int32 if is_int else torch.float32, device=x.device)
    work = torch.empty_like(blur) if want_work and is_int else None
    _SMOOTH(x.device, x.data_ptr(), blur.data_ptr(), None if work is None else work.data_ptr(),
            *x.shape, _DTYPES.index(x.dtype), radius, strength)
    LAUNCHES["mosquito_nr_smooth"] += 1
    return blur, (x if want_work and not is_int else work)
