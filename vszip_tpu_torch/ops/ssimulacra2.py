"""SSIMULACRA2: Cloudinary's perceptual image-quality metric, version 2.1
(the port of ``vszip_tpu.ops.ssimulacra2``; the reference's
src/filters/ssimulacra2.zig and src/vapoursynth/ssimulacra2.zig).

Inputs are converted to linear RGBS (``core.resample.to_rgbs`` and
``srgb_to_linear``).  Per frame and per scale s in 0..5 (each scale a
clamped 2x2 box downscale of the previous):

* the XYB opsin transform (absorbance matrix, the reference's VCL2 ``cbrt``
  from ``ops/vcl.py``, per-channel affine),
* per channel: 9-tap separable Gaussian blurs of mu1, mu2, im1*im2 and
  (im1-im2)^2 with the reference's hybrid edge rule, then
* the SSIM map ``1 - num_m*num_s/den_s`` and the asymmetric artifact /
  detail-loss maps, and their 1-norm and 4-norm averages,
* the 108-weight fold, the cubic polynomial and the power nonlinearity.

Zero-weight (plane, scale) pairs are pruned as the reference's comptime skip
table prunes them: at 1080p, 11 of the 18 pairs remain.  Each remaining
pair with h, w >= 16 goes through B13 (``kernels.ssim.ssim_sums``), which
runs its kernel on CUDA tensors and its plain version on CPU tensors; the
smaller pairs of the deepest scales of small inputs take the whole-plane
torch path ``_plane_sums_xla``.

Every f32 product and sum rounds on its own, as the reference and the TPU
kernel do.  XLA:CPU's jit contracts the JAX package's blur ladder and XYB
mix into FMA, so the score agrees with the JAX package on the CPU within the
metric's rtol 1e-3, not bit for bit; the blur agrees with the JAX package's
``jax.disable_jit()`` evaluation exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.clip import Clip
from ..core.format import SampleType
from ..core.params import VSZipError
from ..core.resample import pick_matrix, srgb_to_linear, to_rgbs
from ..kernels import ssim as kernels
from ..kernels.ssim import ssim_maps
from ..trace import spanned
from .vcl import cbrt

FILTER_NAME = "SSIMULACRA2"

# ssimulacra2 v2.1 fitted weights (public metric constants)
WEIGHT = np.array([
    0.0, 0.0007376606707406586, 0.0, 0.0, 0.0007793481682867309, 0.0,
    0.0, 0.0004371155730107379, 0.0, 1.1041726426657346, 0.00066284834129271,
    0.00015231632783718752, 0.0, 0.0016406437456599754, 0.0,
    1.8422455520539298, 11.441172603757666, 0.0, 0.0007989109436015163,
    0.000176816438078653, 0.0, 1.8787594979546387, 10.94906990605142, 0.0,
    0.0007289346991508072, 0.9677937080626833, 0.0, 0.00014003424285435884,
    0.9981766977854967, 0.00031949755934435053, 0.0004550992113792063, 0.0,
    0.0, 0.0013648766163243398, 0.0, 0.0, 0.0, 0.0, 0.0, 7.466890328078848,
    0.0, 17.445833984131262, 0.0006235601634041466, 0.0, 0.0,
    6.683678146179332, 0.00037724407979611296, 1.027889937768264,
    225.20515300849274, 0.0, 0.0, 19.213238186143016, 0.0011401524586618361,
    0.001237755635509985, 176.39317598450694, 0.0, 0.0, 24.43300999870476,
    0.28520802612117757, 0.0004485436923833408, 0.0, 0.0, 0.0,
    34.77906344483772, 44.835625328877896, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
    0.0, 0.0, 0.0008680556573291698, 0.0, 0.0, 0.0, 0.0, 0.0,
    0.0005313191874358747, 0.0, 0.00016533814161379112, 0.0, 0.0, 0.0, 0.0,
    0.0, 0.0004179171803251336, 0.0017290828234722833, 0.0,
    0.0020827005846636437, 0.0, 0.0, 8.826982764996862, 23.19243343998926,
    0.0, 95.1080498811086, 0.9863978034400682, 0.9834382792465353,
    0.0012286405048278493, 171.2667255897307, 0.9807858872435379, 0.0, 0.0,
    0.0, 0.0005130064588990679, 0.0, 0.00010854057858411537,
], np.float64)
assert WEIGHT.shape == (108,)

_PRUNE = 0.01
# frames of 1080p per chunk: the pyramid holds a dozen full-frame f32
# intermediates, so longer clips run in chunks of this many pixels
CHUNK_PIXELS = 16 * 1080 * 1920
# smallest plane (both sides) that goes through B13
MIN_KERNEL_SIDE = 16


def _skip(plane: int, scale: int):
    base = plane * 36 + scale * 6
    return dict(
        ssim=WEIGHT[base] <= _PRUNE and WEIGHT[base + 3] <= _PRUNE,
        artifact=WEIGHT[base + 1] <= _PRUNE and WEIGHT[base + 4] <= _PRUNE,
        detailloss=WEIGHT[base + 2] <= _PRUNE and WEIGHT[base + 5] <= _PRUNE,
    )


def _downscale2(x):
    """Clamped 2x2 box downscale, (N,H,W) -> (N,ceil(H/2),ceil(W/2)):
    ``(((a+b)+c)+d) * 0.25`` with a, b, c, d in row-major order, which is
    what the JAX package's reduce_window computes under XLA:CPU's jit (its
    docstring's ``(a+b)+(c+d)`` describes the TPU)."""
    n, h, w = x.shape
    if h % 2 or w % 2:
        x = torch.nn.functional.pad(x.unsqueeze(1), (0, w % 2, 0, h % 2),
                                    mode="replicate").squeeze(1)
    a, b = x[:, 0::2, 0::2], x[:, 0::2, 1::2]
    c, d = x[:, 1::2, 0::2], x[:, 1::2, 1::2]
    return (((a + b) + c) + d) * 0.25


_K_M = np.array([
    [0.30, 1.0 - 0.078 - 0.30, 0.078],
    [0.23, 1.0 - 0.078 - 0.23, 0.078],
    [0.24342269, 0.20476745, 1.0 - 0.24342269 - 0.20476745],
], np.float32)
_K_BIAS = float(np.float32(0.0037930734))
_K_D1 = float(np.float32(np.cbrt(0.0037930734)))


def _to_xyb(r, g, b):
    mix = []
    for row in _K_M:
        k0, k1, k2 = (float(v) for v in row)
        # right-associated like the reference's fma chain
        # (ssimulacra2.zig:428-430 mulAdd(m0, r, mulAdd(m1, g,
        # mulAdd(m2, b, bias))))
        m = k0 * r + (k1 * g + (k2 * b + _K_BIAS))
        mix.append(cbrt(torch.clamp(m, min=0.0)) - _K_D1)
    cx, cy, cz = mix
    xv = 0.5 * (cx - cy)
    yv = 0.5 * (cx + cy)
    return xv * 14.0 + 0.42, yv + 0.01, (cz - yv) + 0.55


def _norms_raw(m):
    """Whole-plane f32 sums of m and m^4, widened to f64."""
    s1 = m.sum(dim=(1, 2)).to(torch.float64)
    s4 = ((m * m) * (m * m)).sum(dim=(1, 2)).to(torch.float64)
    return s1, s4


def _plane_sums_xla(im1, im2, need_ssim: bool, need_err: bool):
    """Raw map sums [ssim_1, ssim_4, art_1, art_4, det_1, det_4], each (N,)
    f64, with whole-plane f32 sums (the JAX package's XLA path)."""
    zero = torch.zeros((im1.shape[0],), dtype=torch.float64, device=im1.device)
    d1, art, det = ssim_maps(im1, im2, need_ssim, need_err)
    ssim1, ssim4 = _norms_raw(d1) if need_ssim else (zero, zero)
    art1, art4 = _norms_raw(art) if need_err else (zero, zero)
    det1, det4 = _norms_raw(det) if need_err else (zero, zero)
    return ssim1, ssim4, art1, art4, det1, det4


def _plane_sums(im1, im2, need_ssim: bool, need_err: bool):
    """Dispatch: B13 (band partials folded in f64; the kernel on a CUDA
    tensor, its plain version on a CPU tensor) when both sides are at least
    16, the whole-plane torch path below that."""
    h, w = im1.shape[1], im1.shape[2]
    if h >= MIN_KERNEL_SIDE and w >= MIN_KERNEL_SIDE:
        s = kernels.ssim_sums(im1.contiguous(), im2.contiguous(), need_ssim, need_err)
        return tuple(s[:, k] for k in range(6))
    return _plane_sums_xla(im1, im2, need_ssim, need_err)


def _ssimulacra2_frames(planes1, planes2):
    """planes: 3-tuples of (N,H,W) f32 linear RGB.  Returns (N,) scores."""
    n = planes1[0].shape[0]
    dev = planes1[0].device
    terms = {}
    src1, src2 = planes1, planes2
    for scale in range(6):
        if scale > 0:
            src1 = tuple(_downscale2(p) for p in src1)
            src2 = tuple(_downscale2(p) for p in src2)
        npix = 1.0 / float(src1[0].shape[1] * src1[0].shape[2])
        xyb1 = _to_xyb(*src1)
        xyb2 = _to_xyb(*src2)
        for plane in range(3):
            sk = _skip(plane, scale)
            need_ssim = not sk["ssim"]
            need_err = not (sk["artifact"] and sk["detailloss"])
            if not (need_ssim or need_err):
                continue
            raw = _plane_sums(xyb1[plane], xyb2[plane], need_ssim, need_err)
            terms[(scale, plane)] = (
                raw[0] * npix, torch.sqrt(torch.sqrt(raw[1] * npix)),
                raw[2] * npix, torch.sqrt(torch.sqrt(raw[3] * npix)),
                raw[4] * npix, torch.sqrt(torch.sqrt(raw[5] * npix)))

    # fold in the reference's weight order (plane-major, scale, then
    # [ssim, artifact, detailloss] x [1-norm, 4-norm]); pruned pairs add 0
    score = torch.zeros((n,), dtype=torch.float64, device=dev)
    for plane in range(3):
        for scale in range(6):
            if (scale, plane) not in terms:
                continue
            ssim1, ssim4, art1, art4, det1, det4 = terms[(scale, plane)]
            base = plane * 36 + scale * 6
            for k, v in enumerate((ssim1, art1, det1, ssim4, art4, det4)):
                score = score + float(WEIGHT[base + k]) * v.abs()

    ssim = score * 0.9562382616834844
    ssim = (
        6.248496625763138e-5 * ssim * ssim * ssim
        + 2.326765642916932 * ssim
        - 0.020884521182843837 * ssim * ssim
    )
    return torch.where(ssim > 0.0, torch.pow(ssim, 0.6276336467831387) * -10.0 + 100.0,
                       100.0)


def _chunk_scores(c1: Clip, c2: Clip, lin1: bool, lin2: bool, mat1: int = 6,
                  mat2: int = 6):
    """One chunk's pipeline: toRGBS, the sRGB EOTF where the input is not
    linear already, and the metric."""
    r1 = to_rgbs(c1, matrix=mat1)
    r2 = to_rgbs(c2, matrix=mat2)
    if not lin1:
        r1 = srgb_to_linear(r1)
    if not lin2:
        r2 = srgb_to_linear(r2)
    return _ssimulacra2_frames(tuple(r1.planes), tuple(r2.planes))


@spanned("vszip.op.ssimulacra2")
def ssimulacra2(reference: Clip, distorted: Clip) -> Clip:
    """Returns a copy of `reference` carrying the per-frame prop
    SSIMULACRA2 ((N,) f64 on the planes' device; the reference props a copy
    of src1)."""
    if (reference.width, reference.height) != (distorted.width, distorted.height):
        raise VSZipError(f"{FILTER_NAME}: clips must have the same dimensions.")
    if reference.num_frames != distorted.num_frames:
        raise VSZipError(f"{FILTER_NAME}: clips must have the same length.")
    for c in (reference, distorted):
        if (c.format.sample_type is SampleType.FLOAT
                and c.format.bits_per_sample == 16):
            raise VSZipError(f"{FILTER_NAME}: half precision input is not supported.")

    lin1 = reference.props.get("_Transfer") == 8
    lin2 = distorted.props.get("_Transfer") == 8
    mat1 = pick_matrix(reference)
    mat2 = pick_matrix(distorted)
    chunk = max(1, CHUNK_PIXELS // max(reference.width * reference.height, 1))
    n = reference.num_frames

    def sub(clip, i):
        return Clip(tuple(p[i: i + chunk] for p in clip.planes), clip.format, {})

    parts = [_chunk_scores(sub(reference, i), sub(distorted, i), lin1, lin2, mat1, mat2)
             for i in range(0, n, chunk)]
    scores = parts[0] if len(parts) == 1 else torch.cat(parts)
    return reference.with_props(SSIMULACRA2=scores)
