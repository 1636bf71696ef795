"""Bilateral: edge-preserving smoothing, two algorithms.

The PyTorch counterpart of ``vszip_tpu.ops.bilateral`` (reference
src/filters/bilateral.zig + src/vapoursynth/bilateral.zig), with the same
arguments, messages and create-time derivation (sigmaS chroma scaling,
PBFICnum auto, radius/step/samples, algorithm auto-select, plane disable on
zero sigmas) as host Python.

* alg2 ("truncated"): spatial window of sub-sampled taps ``(+-yy, +-xx)``
  for xx, yy in {1, 1+step, ...} < radius+1 with replicated edges, spatial
  weights from the Gaussian LUT and range weights evaluated in f32 (``exp``
  of the scaled, clamped |diff|; floats index at ``trunc(min(1,|d|)*65535 +
  0.5)`` with |d| taken in the storage dtype).  Sums keep the reference's
  (yy, xx) order and its four-offset grouping, each product and sum rounded
  on its own.  ``_truncated`` describes each plane as a
  ``kernels.bilateral.Window``; ``kernels.bilateral.bilateral_window`` runs
  the call's windows together: one CUDA launch for all of them on the card,
  the plain torch version on the CPU.
* alg1 (PBFIC, Yang et al.): per luminance level a range-weight plane Wk and
  product Jk, smoothed by the forward+backward van Vliet IIR (horizontal pass
  with the ends passed through, vertical pass with them computed), then
  Jk/Wk linearly interpolated between the two levels that bracket the
  reference pixel.  Levels run one at a time; only the two bracket
  accumulators are kept, so memory does not grow with PBFICnum.  Plain torch
  on either device.

Integer planes are computed in int32/f32 (torch lacks uint16 pads and
clamps).  ``exp`` differs by an ulp or two between XLA:CPU, torch's CPU and
CUDA, so outputs may differ from the JAX package by 1 LSB on a few pixels.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.clip import Clip
from ..core.format import ColorFamily, SampleType
from ..core.params import VSZipError, compare_clips, get_array, parse_planes
from ..kernels import bilateral as kbl
from ..kernels.bilateral import _gr_consts, _range_index, _weight_
from ..trace import spanned

FILTER_NAME = "Bilateral"
_NP_DTYPES = {torch.float16: np.float16, torch.float32: np.float32}


# ---------------------------------------------------------------------------
# create-time derivations (host NumPy)
# ---------------------------------------------------------------------------

def _gs_lut(radius: int, sigma_s: float) -> np.ndarray:
    upper = radius + 1
    y, x = np.mgrid[0:upper, 0:upper].astype(np.float64)
    return np.exp((x * x + y * y) / (sigma_s * sigma_s * -2.0)).astype(np.float32)


def _recursive_gaussian_params(sigma: float):
    q = (
        3.97156 - 4.14554 * math.sqrt(1 - 0.26891 * sigma)
        if sigma < 2.5
        else 0.98711 * sigma - 0.96330
    )
    den = 1.57825 + 2.44413 * q + 1.4281 * q * q + 0.422205 * q**3
    n1 = 2.44413 * q + 2.85619 * q * q + 1.26661 * q**3
    n2 = -(1.4281 * q * q + 1.26661 * q**3)
    n3 = 0.422205 * q**3
    b = np.float32(1 - (n1 + n2 + n3) / den)
    return b, np.float32(n1 / den), np.float32(n2 / den), np.float32(n3 / den)


# ---------------------------------------------------------------------------
# alg2: truncated spatial window
# ---------------------------------------------------------------------------

def _truncated(src, ref, gs: np.ndarray, sigma_r: float, hist_len: int, radius: int,
               step: int, peak: float, is_int: bool) -> kbl.Window:
    """Algorithm 2 on one plane, as the window ``kbl.bilateral_window`` runs
    with the call's others."""
    return kbl.Window(src, ref, gs, sigma_r, hist_len, radius, step, peak, is_int)


# ---------------------------------------------------------------------------
# alg1: PBFIC with recursive Gaussian
# ---------------------------------------------------------------------------

def _iir_scan_(x: torch.Tensor, coefs, compute_ends: bool) -> torch.Tensor:
    """Forward+backward van Vliet IIR along the first axis of `x`, in
    place, with the reference's warm-up: compute_ends=True (vertical pass)
    computes the first forward and last backward element from history seeded
    with their own value; False (horizontal pass) passes them through.  Each
    step is ``((b*v + b1*o1) + b2*o2) + b3*o3``, term by term."""
    b, b1, b2, b3 = coefs
    length = x.shape[0]
    tmp = torch.empty_like(x[0])

    def ends(v):
        o = torch.mul(v, b)
        for c in (b1, b2, b3):
            o.add_(torch.mul(v, c, out=tmp))
        v.copy_(o)

    def sweep(order):
        for j, i in enumerate(order[1:], 1):
            o = x[i].mul_(b)
            for c, back in ((b1, 1), (b2, 2), (b3, 3)):
                o.add_(torch.mul(x[order[max(j - back, 0)]], c, out=tmp))

    if compute_ends:
        ends(x[0])
    sweep(list(range(length)))
    if compute_ends:
        ends(x[length - 1])
    sweep(list(range(length - 1, -1, -1)))
    return x


def _bracket(pb: torch.Tensor, reff: torch.Tensor, num: int) -> torch.Tensor:
    """The bracketing level k per pixel (int32), the reference's loop: the
    first k in 0..num-3 with pb[k] <= ref < pb[k+1], else num-2 (NaN and
    values below pb[0] too).  The levels increase, so that k is the number of
    levels <= ref, less one."""
    k = torch.searchsorted(pb, reff, right=True).sub_(1).to(torch.int32)
    return k.masked_fill_((k < 0) | (k > num - 3) | torch.isnan(reff), num - 2)


def _pbfic(src, ref, num: int, sigma_s: float, peak: float, is_int: bool,
           sigma_r: float = 0.02, hist_len: int = 65536):
    coefs = tuple(float(c) for c in _recursive_gaussian_params(sigma_s))
    if is_int:
        ks = np.arange(num, dtype=np.float32)
        pbfick = np.clip(
            np.trunc(peak * ks / np.float32(num - 1) + 0.5), 0, peak
        ).astype(np.float32)
    else:
        pbfick = (np.arange(num) / np.float64(num - 1)).astype(np.float32)
    consts = _gr_consts(hist_len, sigma_r)
    dev = src.device

    reff = ref.to(torch.float32)
    srcf = src.to(torch.float32)
    refw = ref.to(torch.int32) if is_int else ref
    pb = torch.from_numpy(pbfick).to(dev)
    k_sel = _bracket(pb, reff, num)
    lo = torch.zeros_like(reff)
    hi = torch.zeros_like(reff)
    for k in range(num):
        # the level's value in the reference's dtype (f16 rounds it)
        level = torch.from_numpy(np.asarray(pbfick[k]).astype(
            np.int32 if is_int else _NP_DTYPES[ref.dtype])).to(dev)
        wk = _weight_(_range_index(level, refw, is_int), consts)
        wj = torch.stack((wk, wk * srcf))        # (2, N, H, W): Wk and Jk together
        del wk
        # horizontal pass (axis 2), then vertical (axis 1), each on a copy
        # with the scanned axis first
        h = _iir_scan_(wj.movedim(3, 0).contiguous(), coefs, False)
        wj = h.movedim(0, 3)
        v = _iir_scan_(wj.movedim(2, 0).contiguous(), coefs, True)
        wk, jk = v.movedim(0, 2).unbind(0)
        plane = torch.where(wk == 0, 0.0, jk / wk)
        del h, v, wk, jk, wj
        if k <= num - 2:
            lo = torch.where(k_sel == k, plane, lo)
        if k >= 1:
            hi = torch.where(k_sel == k - 1, plane, hi)
        del plane
    p0 = pb[k_sel]
    p1 = pb[k_sel + 1]
    vf = (p1 - reff).mul_(lo).add_((reff - p0).mul_(hi)).div_(p1 - p0)
    if is_int:
        return vf.add_(0.5).clamp_(0.0, peak).trunc_().to(torch.int32).to(src.dtype)
    return vf.to(src.dtype)


# ---------------------------------------------------------------------------
# public op
# ---------------------------------------------------------------------------

@spanned("vszip.op.bilateral.derive", profiled=False)
def _derive(clip: Clip, ref: Clip | None, sigmaS, sigmaR, planes, algorithm, PBFICnum):
    """Validate the call and derive each plane's parameters as the
    reference's create step does: (process, sigmaS, sigmaR, PBFICnum, radius,
    step, algorithm), each per plane."""
    fmt = clip.format
    if fmt.sample_type is SampleType.INTEGER and fmt.bits_per_sample == 32:
        raise VSZipError(f"{FILTER_NAME}: not supported Int format.")
    yuv = fmt.color_family is ColorFamily.YUV

    # sigmaS defaulting incl. chroma subsampling scaling (reference :104-125)
    if sigmaS is None:
        sigmaS = []
    elif not isinstance(sigmaS, (list, tuple)):
        sigmaS = [sigmaS]
    s_s = [0.0] * 3
    for i in range(3):
        if i < len(sigmaS):
            s_s[i] = float(sigmaS[i])
        elif i == 0:
            s_s[0] = 3.0
        elif i == 1 and yuv and fmt.subsampling_h and fmt.subsampling_w:
            factor = float((1 << fmt.subsampling_h) * (1 << fmt.subsampling_w))
            s_s[1] = s_s[0] / math.sqrt(factor)
        else:
            s_s[i] = s_s[i - 1]
        if s_s[i] < 0:
            raise VSZipError(
                'Bilateral: Invalid "sigmaS" assigned, must be non-negative '
                "float number"
            )

    s_r = get_array(sigmaR, "sigmaR", 0.02, 0.0, float("inf"), FILTER_NAME)
    alg = get_array(algorithm, "algorithm", 0, 0, 2, FILTER_NAME)
    pbficnum = get_array(PBFICnum, "PBFICnum", 0, 0, 256, FILTER_NAME)
    process = parse_planes(planes, fmt.num_planes, FILTER_NAME)
    process += [False] * (3 - len(process))

    for i in range(3):
        if s_s[i] == 0 or s_r[i] == 0:
            process[i] = False
    for num in pbficnum:
        if num == 1:
            raise VSZipError(
                'Bilateral: Invalid "PBFICnum" assigned, must be integer '
                "ranges in [0,256] except 1"
            )

    pbficnum = [int(v) for v in pbficnum]
    for i in range(3):
        if process[i] and pbficnum[i] == 0:
            if s_r[i] >= 0.08:
                pbficnum[i] = 4
            elif s_r[i] >= 0.015:
                pbficnum[i] = min(16, int(4 * 0.08 / s_r[i] + 0.5))
            else:
                pbficnum[i] = min(32, int(16 * 0.015 / s_r[i] + 0.5))
            if i > 0 and yuv and pbficnum[i] % 2 == 0 and pbficnum[i] < 256:
                pbficnum[i] += 1

    radius = [0] * 3
    step = [0] * 3
    samples = [0] * 3
    for i in range(3):
        if not process[i]:
            continue
        orad = max(int(s_s[i] * 2 + 0.5), 1)
        step[i] = 1 if orad < 4 else (2 if orad < 8 else 3)
        samples[i] = 1
        radius[i] = 1 + (samples[i] - 1) * step[i]
        while orad * 2 > radius[i] * 3:
            samples[i] += 1
            radius[i] = 1 + (samples[i] - 1) * step[i]
            if radius[i] >= orad and samples[i] > 2:
                samples[i] -= 1
                radius[i] = 1 + (samples[i] - 1) * step[i]
                break

    alg = [int(a) for a in alg]
    for i in range(3):
        if process[i] and alg[i] <= 0:
            if step[i] == 1:
                alg[i] = 2
            elif s_r[i] < 0.08 and samples[i] < 5:
                alg[i] = 2
            elif 4 * samples[i] * samples[i] <= 15 * pbficnum[i]:
                alg[i] = 2
            else:
                alg[i] = 1

    for i in range(fmt.num_planes):
        if process[i] and alg[i] == 2:
            pw, ph = clip.plane_dims(i)
            if pw <= 2 * radius[i] or ph <= 2 * radius[i]:
                raise VSZipError(
                    "Bilateral: plane too small for the spatial radius derived "
                    "from sigmaS; lower sigmaS or use a larger clip."
                )

    if ref is not None:
        compare_clips([clip, ref], FILTER_NAME, same_len=False, bigger_than=True)
    return process, s_s, s_r, pbficnum, radius, step, alg


@spanned("vszip.op.bilateral.plane", profiled=False)
def _plane(x: torch.Tensor, rp: torch.Tensor, num: int, sigma_s: float, sigma_r: float,
           hist_len: int, is_int: bool) -> torch.Tensor:
    """Algorithm 1's output plane."""
    return _pbfic(x, rp, num, float(sigma_s), float(hist_len - 1), is_int,
                  sigma_r=float(sigma_r), hist_len=hist_len)


@spanned("vszip.op.bilateral")
def bilateral(clip: Clip, ref: Clip | None = None, sigmaS=None, sigmaR=None,
              planes=None, algorithm=None, PBFICnum=None) -> Clip:
    process, s_s, s_r, pbficnum, radius, step, alg = _derive(
        clip, ref, sigmaS, sigmaR, planes, algorithm, PBFICnum)
    fmt = clip.format
    hist_len = fmt.hist_len()
    is_int = fmt.sample_type is SampleType.INTEGER
    rclip = ref if ref is not None else clip
    out, windows = [], {}
    nf = clip.num_frames
    for p in range(fmt.num_planes):
        x = clip.planes[p]
        if process[p]:
            rp = x if rclip is clip else rclip.planes[p][:nf]
            if alg[p] == 2:
                # the window kernel takes contiguous planes (a clip may hold views)
                x = x.contiguous()
                rp = x if rclip is clip else rp.contiguous()
                windows[p] = _truncated(x, rp, _gs_lut(radius[p], s_s[p]).reshape(-1),
                                        float(s_r[p]), hist_len, radius[p], step[p],
                                        float(hist_len - 1), is_int)
            else:
                x = _plane(x, rp, pbficnum[p], s_s[p], s_r[p], hist_len, is_int)
        out.append(x)
    if windows:
        for p, plane in zip(windows, kbl.bilateral_window(tuple(windows.values()))):
            out[p] = plane
    return clip.with_planes(out)
