"""EEDI3 kernels: CUDA wrappers, their plain PyTorch versions, and launch
counters.

=====================  ================================================  =====================
wrapper                replaces (vszip_tpu/kernels/...)                  CUDA kernel
=====================  ================================================  =====================
``eedi3_fused``        ``eedi3_fused_pallas`` (eedi3_fused_pallas.py:300)  eedi3_line_kernel<0,M,K>
``eedi3_fused_hp``     ``eedi3_fused_hp_pallas`` (:607)                   eedi3_line_kernel<1,0,K>
``vcheck``             ``vcheck_pallas`` (vcheck_pallas.py:163)           vcheck_kernel
=====================  ================================================  =====================

Each has its TPU kernel's signature.  ``eedi3_fused``/``eedi3_fused_hp``
take the four padded neighbour rows r3p, r1p, r1n, r3n, each (B, L,
w + 2*PAD) f32, the cost coefficients as the op scales them (alpha/3,
beta/255, gamma/255, and 1 - alpha - beta from the unscaled pair) and, for
the non-hp kernel, an optional (B, L, w) bool mclip gate; they return
(out f32, fpath int32), each (B, L, w): the cost matrix, the Viterbi DP,
the backtrack and the directional interpolation of every line.  ``vcheck``
takes the pre-gathered per-line inputs of the reliability pass, dl and cint
(n_off, B, W) f32, nb (n_off, 3, B, W) f32 (rows pd-1, pd+1, pd+2), dm
(n_off, 3, B, W) int32 (directions of lines off-1, off, off+1) and init
(B, W), and returns the updated lines (n_off, B, W).

Each dispatches on its tensors' device: CPU tensors take the plain versions
(``ops/eedi3.py``'s cost, DP and output functions for B8/B9, the line loop
below for B10), CUDA tensors launch the kernels in ``csrc/eedi3.cu`` or
raise.  Nothing falls back.  The TPU kernels' limits (``fused_fits``, the
8-step x padding, the select chains and one-hot sums standing in for
gathers, the B_BLK batch padding) are not carried over.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build, trace

PAD = 96  # padded margin per side of a neighbour row
BIG = np.float32(np.finfo(np.float32).max * 0.9)  # the DP's cost ceiling

# Launches made on the CUDA path, per wrapper.  Each wrapper adds one where
# it launches its kernel and nowhere else; the plain versions never count.
LAUNCHES = trace.register_launches({"eedi3_fused": 0, "eedi3_fused_hp": 0, "vcheck": 0})


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def eedi3_fused_ref(r3p, r1p, r1n, r3n, w, mdis, nrad, alpha, beta, gamma, omab,
                    bmask=None):
    """Plain version of ``eedi3_fused``: the stacked cost matrix, the DP and
    backtrack, the 4-tap output (fpath zeroed outside the mask)."""
    from ..ops.eedi3 import _costs_nonhp, _dp, _output_nonhp

    tc = torch.stack(_costs_nonhp(r3p, r1p, r1n, r3n, mdis, nrad, alpha, beta, omab))
    fpath = _dp(tc, bmask, gamma, False)
    del tc
    return _output_nonhp(r3p, r1p, r1n, r3n, fpath, w, mdis), fpath


def eedi3_fused_hp_ref(r3p, r1p, r1n, r3n, w, mdis, nrad, alpha, beta, gamma, omab):
    """Plain version of ``eedi3_fused_hp``."""
    from ..ops.eedi3 import _costs_hp, _dp, _output_hp

    tc = torch.stack(_costs_hp(r3p, r1p, r1n, r3n, mdis, nrad, alpha, beta, omab))
    fpath = _dp(tc, None, gamma, True)
    del tc
    return _output_hp(r3p, r1p, r1n, r3n, fpath, w, None, mdis), fpath


def _gather_x(rows: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """rows (S, B, W), o (B, W) int: rows[s, b, clamp(x + o[b, x], 0, W-1)],
    the edge-padded shifts of the JAX package's gathers."""
    s, b, w = rows.shape
    x = torch.arange(w, device=o.device, dtype=torch.int64)
    idx = (x + o.to(torch.int64)).clamp(0, w - 1)
    return rows.gather(2, idx.unsqueeze(0).expand(s, b, w))


def vcheck_line(d2p, dl, d1p, d1n, d2n, cint, dm_p, dm_c, dm_n, w, hp, vcheck,
                rcp0, rcp1, rcp2, vt2):
    """One line of the reliability pass (reference vcheckLine): (B, W) rows
    in, the updated line out."""
    col = torch.arange(w, device=dl.device, dtype=torch.int32)
    keep = dm_c == 0
    keep |= (torch.maximum(dm_c * dm_p, dm_c * dm_n) < 0) | ((dm_p == dm_n) & (dm_p == 0))
    if hp:
        even = (dm_c & 1) == 0
        maxoff = torch.where(even, (dm_c >> 1).abs(),
                             torch.maximum((dm_c >> 1).abs(), ((dm_c + 1) >> 1).abs()))
    else:
        maxoff = dm_c.abs()
    keep |= (col + maxoff >= w) | (col - maxoff < 0)

    up = torch.stack([d2p, d1p, dl])
    dn = torch.stack([dl, d1n, d2n])
    if hp:
        d20 = dm_c >> 1
        d21 = (dm_c + 1) >> 1
        a20, a21 = _gather_x(up, d20), _gather_x(up, d21)
        b20, b21 = _gather_x(dn, -d20), _gather_x(dn, -d21)
        s2ps, s1ps, pa0 = a20[0] + a21[0], a20[1] + a21[1], a20[2] + a21[2]
        ps0, s1ns, s2ns = b20[0] + b21[0], b20[1] + b21[1], b20[2] + b21[2]
        it_o = (s2ps + ps0) * 0.25
        vt_o = ((s2ps - s1ps).abs() + (pa0 - s1ps).abs()) * 0.5
        ib_o = (pa0 + s2ns) * 0.25
        vb_o = ((s2ns - s1ns).abs() + (ps0 - s1ns).abs()) * 0.5
        # even directions: offh = dm >> 1 = d20, so a20/b20 serve
        it_e = (a20[0] + b20[0]) * 0.5
        ib_e = (a20[2] + b20[2]) * 0.5
        vt_e = (a20[0] - a20[1]).abs() + (a20[2] - a20[1]).abs()
        vb_e = (b20[2] - b20[1]).abs() + (b20[0] - b20[1]).abs()
        it = torch.where(even, it_e, it_o)
        ib = torch.where(even, ib_e, ib_o)
        vt = torch.where(even, vt_e, vt_o)
        vb = torch.where(even, vb_e, vb_o)
        dabs = dm_c.abs() >> 1
    else:
        gu = _gather_x(up, dm_c)
        gd = _gather_x(dn, -dm_c)
        it = (gu[0] + gd[0]) * 0.5
        ib = (gu[2] + gd[2]) * 0.5
        vt = (gu[0] - gu[1]).abs() + (gu[2] - gu[1]).abs()
        vb = (gd[2] - gd[1]).abs() + (gd[0] - gd[1]).abs()
        dabs = dm_c.abs()

    vc = (dl - d1p).abs() + (dl - d1n).abs()
    d0 = (it - d1p).abs()
    d1_ = (ib - d1n).abs()
    d2_ = (vt - vc).abs()
    d3_ = (vb - vc).abs()
    if vcheck == 1:
        m0, m1 = torch.minimum(d0, d1_), torch.minimum(d2_, d3_)
    elif vcheck == 2:
        m0 = (d0 + d1_) * 0.5
        m1 = (d2_ + d3_) * 0.5
    else:
        m0, m1 = torch.maximum(d0, d1_), torch.maximum(d2_, d3_)
    a0 = m0 * rcp0
    a1 = m1 * rcp1
    a2 = ((vt2 - dabs.to(torch.float32)) * rcp2).clamp(min=0.0)
    a = torch.maximum(a0, torch.maximum(a1, a2)).clamp(max=1.0)
    tl = (1.0 - a) * dl + a * cint
    return torch.where(keep, cint, tl)


def vcheck_ref(dl, nb, dm, cint, init, w, mdis, hp, vcheck, rcp0, rcp1, rcp2, vt2):
    """Plain version of ``vcheck``: the lines in order, each reading the
    line the previous one updated."""
    out = torch.empty_like(dl)
    d2p = init
    for li in range(dl.shape[0]):
        d2p = vcheck_line(d2p, dl[li], nb[li, 0], nb[li, 1], nb[li, 2], cint[li],
                          dm[li, 0], dm[li, 1], dm[li, 2], w, hp, vcheck,
                          rcp0, rcp1, rcp2, vt2)
        out[li] = d2p
    return out


# ---------------------------------------------------------------------------
# entry points (the library is built by ``_build`` at the first launch)
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SCRATCH_WORDS = _build.entry("eedi3", "vz_eedi3_scratch_words", _I, _I, _I,
                              restype=ctypes.c_longlong)
_FUSED = _build.kernel("eedi3", "vz_eedi3_fused", *[_P] * 8, *[_I] * 5, _F, ctypes.c_double,
                       _F, _F, _F)
_VCHECK = _build.kernel("eedi3", "vz_vcheck", *[_P] * 6, *[_I] * 6, *[_F] * 4)


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if (t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous()
            or t.device != device):
        raise ValueError(f"vszip_tpu_torch: {name} takes a contiguous {dtype} "
                         f"{tuple(shape)} on {device}, got {t.dtype} {tuple(t.shape)} "
                         f"on {t.device}")


def _check_rows(rows, w: int, mdis: int, nrad: int) -> tuple[int, int]:
    r3p = rows[0]
    if r3p.device.type != "cuda":
        raise ValueError(f"vszip_tpu_torch: no EEDI3 kernel for device {r3p.device}")
    if r3p.dim() != 3 or r3p.shape[-1] != w + 2 * PAD or w < 1:
        raise ValueError("vszip_tpu_torch: EEDI3 kernels take (B, L, w + 2*96) rows, got "
                         f"{tuple(r3p.shape)} for w={w}")
    if not (1 <= mdis <= 40 and 0 <= nrad <= 3):
        raise ValueError(f"vszip_tpu_torch: EEDI3 kernels take mdis 1-40 and nrad 0-3, "
                         f"got {mdis}, {nrad}")
    for r in rows:
        _check("the EEDI3 kernels", r, torch.float32, r3p.shape, r3p.device)
    return r3p.shape[0], r3p.shape[1]


def _fused(hp: bool, rows, w, mdis, nrad, alpha, beta, gamma, omab, bmask):
    b, l = _check_rows(rows, w, mdis, nrad)
    dev = rows[0].device
    if bmask is not None:
        _check("eedi3_fused's mask", bmask, torch.bool, (b, l, w), dev)
    out = torch.empty((b, l, w), dtype=torch.float32, device=dev)
    fpath = torch.empty((b, l, w), dtype=torch.int32, device=dev)
    # backtrack deltas that do not fit the block's shared memory go to a
    # global scratch of this many words per line
    words = _SCRATCH_WORDS(w, mdis, int(hp))
    scratch = torch.empty(b * l * words, dtype=torch.int32, device=dev)
    _FUSED(dev, *(r.data_ptr() for r in rows), bmask.data_ptr() if bmask is not None else None,
           out.data_ptr(), fpath.data_ptr(), scratch.data_ptr() if words else None, b * l, w,
           mdis, nrad, int(hp), alpha, beta, gamma, omab, float(BIG))
    return out, fpath


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

@trace.spanned("vszip.kernel.eedi3_fused", profiled=False)
def eedi3_fused(r3p, r1p, r1n, r3n, w: int, mdis: int, nrad: int, alpha: float,
                beta: float, gamma: float, omab: float, bmask=None):
    """Non-hp cost, DP, backtrack and 4-tap interpolation of every line (B8);
    (out f32, fpath int32)."""
    if r3p.device.type == "cpu":
        return eedi3_fused_ref(r3p, r1p, r1n, r3n, w, mdis, nrad, alpha, beta, gamma,
                               omab, bmask)
    res = _fused(False, (r3p, r1p, r1n, r3n), w, mdis, nrad, alpha, beta, gamma, omab,
                 bmask)
    LAUNCHES["eedi3_fused"] += 1
    return res


@trace.spanned("vszip.kernel.eedi3_fused_hp", profiled=False)
def eedi3_fused_hp(r3p, r1p, r1n, r3n, w: int, mdis: int, nrad: int, alpha: float,
                   beta: float, gamma: float, omab: float):
    """The same for hp: 4*mdis+1 half-pel directions, +-2 transitions and
    the 8-tap even/odd output (B9)."""
    if r3p.device.type == "cpu":
        return eedi3_fused_hp_ref(r3p, r1p, r1n, r3n, w, mdis, nrad, alpha, beta, gamma,
                                  omab)
    res = _fused(True, (r3p, r1p, r1n, r3n), w, mdis, nrad, alpha, beta, gamma, omab,
                 None)
    LAUNCHES["eedi3_fused_hp"] += 1
    return res


@trace.spanned("vszip.kernel.vcheck", profiled=False)
def vcheck(dl, nb, dm, cint, init, w: int, mdis: int, hp: bool, vcheck: int,
           rcp0: float, rcp1: float, rcp2: float, vt2: float):
    """The line-sequential reliability blend of every frame (B10);
    (n_off, B, W) f32."""
    if dl.device.type == "cpu":
        return vcheck_ref(dl, nb, dm, cint, init, w, mdis, hp, vcheck, rcp0, rcp1, rcp2,
                          vt2)
    if dl.device.type != "cuda":
        raise ValueError(f"vszip_tpu_torch: no vcheck kernel for device {dl.device}")
    n_off, b, width = dl.shape
    if width != w or vcheck not in (1, 2, 3) or mdis < 1:
        raise ValueError(f"vszip_tpu_torch: vcheck takes rows of width w={w}, vcheck 1-3 "
                         f"and mdis >= 1, got width {width}, vcheck {vcheck}, mdis {mdis}")
    for name, t, dt, shape in (("dl", dl, torch.float32, (n_off, b, w)),
                               ("nb", nb, torch.float32, (n_off, 3, b, w)),
                               ("dm", dm, torch.int32, (n_off, 3, b, w)),
                               ("cint", cint, torch.float32, (n_off, b, w)),
                               ("init", init, torch.float32, (b, w))):
        _check(f"vcheck's {name}", t, dt, shape, dl.device)
    out = torch.empty_like(dl)
    _VCHECK(dl.device, dl.data_ptr(), nb.data_ptr(), dm.data_ptr(), cint.data_ptr(),
            init.data_ptr(), out.data_ptr(), n_off, b, w, mdis, int(hp), vcheck, rcp0, rcp1,
            rcp2, vt2)
    LAUNCHES["vcheck"] += 1
    return out
