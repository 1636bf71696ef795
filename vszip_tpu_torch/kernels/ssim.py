"""SSIMULACRA2's per-scale plane statistics (B13): CUDA wrapper, its plain
PyTorch version, and the launch counter.

``ssim_sums`` replaces ``ssim_sums_pallas``
(vszip_tpu/kernels/ssim_pallas.py:159).  For one (scale, plane) pair of
XYB planes im1, im2 (N, H, W) f32 it runs the four 9-tap separable blurs
(mu1, mu2, im1*im2 and (im1-im2)^2; vertical then horizontal, the
reference's hybrid edge rule), forms the SSIM, artifact and detail-loss
maps, and returns their raw 1- and 4-norm sums (N, 6) f64 in the order
[ssim_1, ssim_4, artifact_1, artifact_4, detailloss_1, detailloss_4] (the
4-norm entries are sums of m^4, before the root).

The sums are taken in two stages, as the TPU kernel takes them: each column
of each band of ``b`` rows (b = 64, or 32 when W > 2560) is summed over its
rows in row order in f32, giving (N, nbh, 6, W) f32 band partials, and one
torch sum folds those in f64.  The kernel's band partials equal the plain
version's bit for bit: the file builds with ``-fmad=false`` and IEEE
division, so every product, sum and quotient rounds as the torch op does;
the f64 fold is the same torch call on both paths.

It dispatches on the tensor's device: a CPU tensor takes the plain version,
a CUDA tensor launches ``ssim_band_kernel`` in ``csrc/ssim.cu`` or raises.
Nothing falls back.  The kernel has two variants, chosen by its launcher
(``lane_columns`` in ``csrc/ssim.cu``): 2 columns a lane where the grid
gives every SM seven blocks, else 1, so the small scales spread over the
card.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from .. import _build, trace

# Launches made on the CUDA path.  The wrapper adds one where it launches its
# kernel and nowhere else; the plain version never counts.
LAUNCHES = trace.register_launches({"ssim_sums": 0})

# the reference's 9-tap Gaussian (exact f32 values)
KERNEL = np.array([
    0.0076144188642501831054687500, 0.0360749699175357818603515625,
    0.1095860823988914489746093750, 0.2134445458650588989257812500,
    0.2665599882602691650390625000, 0.2134445458650588989257812500,
    0.1095860823988914489746093750, 0.0360749699175357818603515625,
    0.0076144188642501831054687500,
], np.float32)
RADIUS = 4
_C2 = float(np.float32(0.0009))


def band_rows(w: int) -> int:
    """Rows per band of the partial sums (the TPU kernel's band height)."""
    return 64 if w <= 2560 else 32


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

@lru_cache(maxsize=256)
def tap_index(n: int, off: int) -> np.ndarray:
    """Source index of tap `off` for every output position 0..n-1 under the
    reference blur's hybrid edge rule (ssimulacra2.zig blurH :247-309):
    leading taps reflect-101 (clamped to n-1), trailing taps past the end
    read the fixed index n-1-off (clamped to 0)."""
    j = np.arange(n) + off
    if off < 0:
        return np.where(j < 0, np.minimum(-j, n - 1), j)
    return np.where(j > n - 1, max(n - 1 - off, 0), j)


@lru_cache(maxsize=256)
def _tap_index_on(n: int, off: int, device: torch.device) -> torch.Tensor:
    """``tap_index`` on `device`, cached: a fresh host-to-device copy would
    synchronise the stream on every call."""
    return torch.from_numpy(tap_index(n, off)).to(device)


def blur_1d(x: torch.Tensor, axis: int) -> torch.Tensor:
    """One 9-tap pass along `axis`: ``acc = K0*x0; acc = acc + Kk*xk`` in
    tap order, every product and sum rounded on its own."""
    n = x.shape[axis]
    acc = None
    for k in range(9):
        t = float(KERNEL[k]) * x.index_select(axis, _tap_index_on(n, k - RADIUS, x.device))
        acc = t if acc is None else acc + t
    return acc


def blur(x: torch.Tensor) -> torch.Tensor:
    """9-tap separable Gaussian, vertical then horizontal."""
    return blur_1d(blur_1d(x, 1), 2)


def ssim_maps(im1: torch.Tensor, im2: torch.Tensor, need_ssim: bool, need_err: bool):
    """The SSIM, artifact and detail-loss maps (each (N, H, W) f32, or None
    where not needed).

    The SSIM denominator is built as ``2*(s12 - mu1*mu2) + [blur((im1-im2)^2)
    - (mu1-mu2)^2]`` rather than the reference's ``blur((im1+im2)^2) -
    2*s12`` form (ssimulacra2.zig:228-246, :522): the two agree
    algebraically, and the bracket is exactly zero when im1 == im2, so
    identical inputs score exactly 100 on every device."""
    mu1, mu2 = blur(im1), blur(im2)
    d1 = art = det = None
    if need_ssim:
        s12 = blur(im1 * im2)
        d = im1 - im2
        sd = blur(d * d)
        md = mu1 - mu2
        num_m = 1.0 - md * md
        s12c = s12 - mu1 * mu2
        core = s12c + s12c
        num_s = core + _C2
        den_s = (core + (sd - md * md)) + _C2
        d1 = torch.clamp(1.0 - (num_m * num_s) / den_s, min=0.0)
    if need_err:
        n1 = (im1 - mu1).abs()
        n2 = (im2 - mu2).abs()
        d1e = (1.0 + n2) / (1.0 + n1) - 1.0
        art = torch.clamp(d1e, min=0.0)
        det = torch.clamp(-d1e, min=0.0)
    return d1, art, det


def ssim_partials_ref(im1: torch.Tensor, im2: torch.Tensor, need_ssim: bool,
                      need_err: bool) -> torch.Tensor:
    """Plain version of the kernel's band partials: (N, nbh, 6, W) f32, each
    column of each band summed over the band's rows in row order."""
    n, h, w = im1.shape
    b = band_rows(w)
    nbh = -(-h // b)
    out = torch.zeros((n, nbh, 6, w), dtype=torch.float32, device=im1.device)
    for k, m in enumerate(ssim_maps(im1, im2, need_ssim, need_err)):
        if m is None:
            continue
        m4 = (m * m) * (m * m)
        for j, v in enumerate((m, m4)):
            # zero rows past the picture add nothing to a sum of maps >= 0
            vb = torch.nn.functional.pad(v, (0, 0, 0, nbh * b - h)).view(n, nbh, b, w)
            acc = vb[:, :, 0]
            for r in range(1, b):
                acc = acc + vb[:, :, r]
            out[:, :, 2 * k + j] = acc
    return out


def fold(partials: torch.Tensor) -> torch.Tensor:
    """(N, nbh, 6, W) f32 band partials -> (N, 6) f64 sums."""
    return partials.to(torch.float64).sum(dim=(1, 3))


def ssim_sums_ref(im1: torch.Tensor, im2: torch.Tensor, need_ssim: bool,
                  need_err: bool) -> torch.Tensor:
    """Plain version of ``ssim_sums``: (N, 6) f64."""
    return fold(ssim_partials_ref(im1, im2, need_ssim, need_err))


# ---------------------------------------------------------------------------
# entry points (the library is built by ``_build`` at the first launch)
# ---------------------------------------------------------------------------

_PARTIALS = _build.kernel("ssim", "vz_ssim_partials", *[ctypes.c_void_p] * 3,
                          *[ctypes.c_int] * 8)
_LANE_COLUMNS = _build.entry("ssim", "vz_ssim_lane_columns", *[ctypes.c_int] * 5)


def _check(im1: torch.Tensor, im2: torch.Tensor) -> None:
    """Raise unless the kernel takes these planes."""
    if im1.device.type != "cuda":
        raise ValueError(f"vszip_tpu_torch: no SSIM kernel for device {im1.device}")
    for t in (im1, im2):
        if (t.dtype != torch.float32 or t.dim() != 3 or not t.is_contiguous()
                or t.device != im1.device or t.shape != im1.shape):
            raise ValueError("vszip_tpu_torch: ssim_sums takes two contiguous (N, H, W) "
                             f"float32 planes of one shape on one device, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def lane_columns(n: int, h: int, w: int, sms: int) -> int:
    """The kernel's columns a lane that the launcher takes for (N, H, W)
    planes on a card of `sms` SMs (builds the library)."""
    return _LANE_COLUMNS(n, h, w, band_rows(w), sms)


@trace.spanned("vszip.kernel.ssim_sums", profiled=False)
def ssim_partials(im1: torch.Tensor, im2: torch.Tensor, need_ssim: bool,
                  need_err: bool, cols: int | None = None) -> torch.Tensor:
    """B13's band partials, (N, nbh, 6, W) f32.  `cols` forces the kernel's
    variant (2 or 1 columns a lane; tests and tools), else the launcher
    picks it."""
    if im1.device.type == "cpu":
        return ssim_partials_ref(im1, im2, need_ssim, need_err)
    _check(im1, im2)
    if cols not in (None, 1, 2):
        raise ValueError(f"vszip_tpu_torch: ssim_partials takes cols 1 or 2, got {cols}")
    n, h, w = im1.shape
    b = band_rows(w)
    vec = w % 2 == 0 and im1.data_ptr() % 8 == 0 and im2.data_ptr() % 8 == 0
    out = torch.empty((n, -(-h // b), 6, w), dtype=torch.float32, device=im1.device)
    _PARTIALS(im1.device, im1.data_ptr(), im2.data_ptr(), out.data_ptr(), n, h, w, b,
              int(bool(need_ssim)), int(bool(need_err)), cols or 0, int(vec))
    LAUNCHES["ssim_sums"] += 1
    return out


def ssim_sums(im1: torch.Tensor, im2: torch.Tensor, need_ssim: bool,
              need_err: bool) -> torch.Tensor:
    """Raw map sums of one (scale, plane) pair (B13): (N, 6) f64."""
    return fold(ssim_partials(im1, im2, need_ssim, need_err))
