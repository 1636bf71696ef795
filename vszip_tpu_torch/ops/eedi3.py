"""EEDI3 / EEDI3H: edge-directed interpolation via a per-line Viterbi DP.

The PyTorch counterpart of ``vszip_tpu.ops.eedi3`` (reference
src/filters/eedi3.zig + src/vapoursynth/eedi3.zig, an eedi3m float-mode
port), with the same arguments, messages and results.  For every missing
line (field interpolation or dh doubling): build 4 mirror-reflected
neighbour rows (offsets -3,-1,+1,+3), compute a connection-cost matrix over
directions u in [-mdis, mdis] (2*mdis per side half-pel with hp=True), run a
dynamic program across x with +-1 (+-2 for hp) transitions penalised by
gamma, backtrack the optimal direction path, and interpolate along the
chosen direction with a 4-tap (0.5625/-0.0625) kernel.  Optional `mclip`
gates the DP to masked regions (buildBmask look-ahead of mdis); optional
`vcheck` runs the sequential reliability post-pass blending back toward a
vertical interpolation (or `sclip`).  EEDI3H is the same pipeline on
transposed planes.

All lines of all frames batch into one (B, L, W) tensor.  The per-line
pipeline (cost, DP, backtrack, interpolation) is kernel B8
(``kernels/eedi3.py`` ``eedi3_fused``; B9 ``eedi3_fused_hp`` for hp), the
line-sequential vcheck pass kernel B10 (``vcheck``); on CPU tensors the
wrappers run the plain versions below.  hp with mclip has no kernel, in the
JAX package as here: it runs the plain versions on either device.

Every f32 expression keeps the reference's order, each operation rounded on
its own (separate torch ops; the CUDA source builds with -fmad=false):
``tb = (|.|+|.|)+|.|``, the box sums k-ascending from -nrad,
``s = (B(x+u)+B(x))+B(x+2u)``, ``cost = (alpha*s + beta|u|) + omab*v``, the
DP's strict-less candidate order with ``min(bval + cost, 0.9*FLT_MAX)``.
XLA:CPU contracts some of these into FMA under jit, so the JAX package's
jitted CPU path may differ from this by ulps; its strict evaluation (under
``jax.disable_jit()``) does not.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..core.clip import Clip
from ..core.format import ColorFamily, SampleType
from ..core.params import VSZipError
from ..kernels import eedi3 as kernels
from ..trace import spanned

# padded margin per side (reference pad_h: align(2*mdis_max + nrad_max + n_vec))
PAD = kernels.PAD
FLT_MAX_09 = kernels.BIG


@lru_cache(maxsize=64)
def _pad_idx(w: int) -> np.ndarray:
    """index table for the reference's mirrorPad cascade: position p in the
    padded buffer [0, w + 2*PAD) -> source column in [0, w)."""
    n = w + 2 * PAD
    idx = np.zeros(n, np.int64)
    idx[PAD : PAD + w] = np.arange(w)
    for i in range(PAD):  # right: buf[PAD+w+i] = buf[PAD+w-2-i]
        idx[PAD + w + i] = idx[PAD + w - 2 - i]
    for i in range(PAD):  # left: buf[i] = buf[2*PAD - i]
        idx[i] = idx[2 * PAD - i]
    return idx


def _reflect_row(y: int, h: int) -> int:
    if h == 1:
        return 0
    while y < 0 or y >= h:
        if y < 0:
            y = -y
        if y >= h:
            y = 2 * (h - 1) - y
    return y


def _src_col(dh: bool, off: int, n_src: int) -> int:
    return _reflect_row(off, 2 * n_src) // 2 if dh else _reflect_row(off, n_src)


def _take_pad(row: torch.Tensor, off: int) -> torch.Tensor:
    """row: (..., w + 2*PAD) padded row; the w-wide view at data offset
    `off` (padded positions PAD + off .. PAD + off + w)."""
    w = row.shape[-1] - 2 * PAD
    return row[..., PAD + off : PAD + off + w]


def _pad_rows(rows: torch.Tensor) -> torch.Tensor:
    """(B, L, w) -> (B, L, w + 2*PAD) via the mirror cascade: one reflection
    each side for w > PAD+1, the multi-bounce index table otherwise."""
    w = rows.shape[-1]
    if w > PAD + 1:
        left = rows[..., 1 : PAD + 1].flip(-1)
        right = rows[..., w - 1 - PAD : w - 1].flip(-1)
        return torch.cat([left, rows, right], dim=-1)
    idx = torch.from_numpy(_pad_idx(w)).to(rows.device)
    return rows.index_select(-1, idx)


def _shifted(x2: torch.Tensor, t: int, ext: int) -> torch.Tensor:
    """The row at padded position j - t, read from the `ext`-zero-extended
    row `x2` (0 past the mirror pad)."""
    n = x2.shape[-1] - 2 * ext
    return x2[..., ext - t : ext - t + n]


def _ext_rows(rows, ext: int):
    return [F.pad(r, (ext, ext)) for r in rows]


def _box(tb: torch.Tensor, nrad: int) -> torch.Tensor:
    """B(j) = sum_k tb(j+k), k ascending from -nrad, tb zero past its ends."""
    wp = tb.shape[-1]
    tb_e = F.pad(tb, (nrad, nrad))
    acc = None
    for k in range(-nrad, nrad + 1):
        sh = tb_e[..., nrad + k : nrad + k + wp]
        acc = sh if acc is None else acc + sh
    return acc


def _f32(v: float) -> float:
    """A double rounded once to f32, as the JAX package's jnp.float32(v)."""
    return float(np.float32(v))


def _costs_nonhp(r3p, r1p, r1n, r3n, mdis, nrad, alpha, beta, one_minus_ab):
    """list of 2*mdis+1 (B, L, w) connection-cost arrays (one per direction
    u); inputs are padded rows."""
    ext = 2 * mdis
    r1p2, r1n2, r3n2 = _ext_rows((r1p, r1n, r3n), ext)
    alpha, one_minus_ab = _f32(alpha), _f32(one_minus_ab)
    costs = []
    for u in range(-mdis, mdis + 1):
        tu = 2 * u
        # padded-space t_base: value at padded pos j is |a(j) - b(j - 2u)|
        tb = ((r3p - _shifted(r1p2, tu, ext)).abs()
              + (r1p - _shifted(r1n2, tu, ext)).abs()
              + (r1n - _shifted(r3n2, tu, ext)).abs())
        # three window sums (reference costBlockDirect sw0/sw1/sw2) from one
        # k-ascending box ladder: s = (B(x+u) + B(x)) + B(x+2u)
        bx = _box(tb, nrad)
        s = (_take_pad(bx, u) + _take_pad(bx, 0)) + _take_pad(bx, tu)
        ip = (_take_pad(r1p, u) + _take_pad(r1n, -u)) * 0.5
        v = (_take_pad(r1p, 0) - ip).abs() + (_take_pad(r1n, 0) - ip).abs()
        costs.append(alpha * s + _f32(beta * abs(u)) + one_minus_ab * v)
    return costs


def _hp_row(a: torch.Tensor) -> torch.Tensor:
    """half-pel row (computeHpRow): out[j] = .5625*(a[j]+a[j+1]) -
    .0625*(a[j-1]+a[j+2]), circular at the ends (never read in range)."""
    return (0.5625 * (a + torch.roll(a, -1, dims=-1))
            - 0.0625 * (torch.roll(a, 1, dims=-1) + torch.roll(a, -2, dims=-1)))


def _costs_hp(r3p, r1p, r1n, r3n, mdis, nrad, alpha3, beta255, one_minus_ab):
    hp = [_hp_row(r) for r in (r3p, r1p, r1n, r3n)]
    cen = 2 * mdis
    ext = cen
    r1p2, r1n2, r3n2 = _ext_rows((r1p, r1n, r3n), ext)
    hpB2, hpC2, hpD2 = _ext_rows(hp[1:], ext)
    alpha3, one_minus_ab = _f32(alpha3), _f32(one_minus_ab)
    costs = []
    for u in range(-cen, cen + 1):
        uh = u >> 1
        odd = (u & 1) != 0
        lo0 = (-uh - 1) if odd else -uh
        A0, B0, C0, _ = hp if odd else (r3p, r1p, r1n, r3n)
        base_m = ((r3p - _shifted(r1p2, u, ext)).abs()
                  + (r1p - _shifted(r1n2, u, ext)).abs()
                  + (r1n - _shifted(r3n2, u, ext)).abs())
        if odd:
            base0 = ((A0 - _shifted(hpB2, u, ext)).abs()
                     + (B0 - _shifted(hpC2, u, ext)).abs()
                     + (C0 - _shifted(hpD2, u, ext)).abs())
        else:
            base0 = base_m
        # separate k-ascending window sums (reference interpLineHP)
        bm_box = _box(base_m, nrad)
        b0_box = bm_box if not odd else _box(base0, nrad)
        s1 = _take_pad(bm_box, 0)
        s2 = _take_pad(bm_box, u)
        s0 = _take_pad(b0_box, uh)
        ip = (_take_pad(B0, uh) + _take_pad(C0, lo0)) * 0.5
        v = (_take_pad(r1p, 0) - ip).abs() + (_take_pad(r1n, 0) - ip).abs()
        costs.append(alpha3 * (s0 + s1 + s2) + _f32(beta255 * abs(u) * 0.5)
                     + one_minus_ab * v)
    return costs


def _dp(tcosts: torch.Tensor, bmask, gamma: float, hp: bool) -> torch.Tensor:
    """Viterbi DP across x, then the backtrack.  tcosts (tpitch, B, L, W);
    bmask (B, L, W) bool or None.  Returns fpath (B, L, W) int32."""
    tpitch, b, l, w = tcosts.shape
    dev = tcosts.device
    big = torch.tensor(FLT_MAX_09, device=dev)
    npad = 2 if hp else 1
    edge = torch.full((npad, b, l), float(FLT_MAX_09), device=dev)
    # (transition, gamma term) in the reference's candidate order: the first
    # is taken, each later one only if strictly less (non-hp starts from the
    # centre, so a tie with the left neighbour keeps direction 0)
    if hp:
        cands = [(-2, _f32(gamma)), (-1, _f32(gamma * 0.5)), (0, None),
                 (1, _f32(gamma * 0.5)), (2, _f32(gamma))]
    else:
        cands = [(0, None), (-1, _f32(gamma)), (1, _f32(gamma))]
    piTs = torch.zeros((max(w - 1, 0), tpitch, b, l), dtype=torch.int8, device=dev)
    pcost = tcosts[..., 0]
    prev = torch.zeros((tpitch, b, l), dtype=torch.int8, device=dev)
    for x in range(1, w):
        tcx = tcosts[..., x]
        pad = torch.cat([edge, pcost, edge], dim=0)
        bval = bd = None
        for dv, g in cands:
            cv = pad[npad + dv : npad + dv + tpitch]
            if g is not None:
                cv = cv + g
            if bval is None:
                bval = cv
                bd = torch.full((tpitch, b, l), dv, dtype=torch.int8, device=dev)
            else:
                m = cv < bval
                bval = torch.where(m, cv, bval)
                bd = torch.where(m, torch.tensor(dv, dtype=torch.int8, device=dev), bd)
        new_pcost = torch.minimum(bval + tcx, big)
        if bmask is not None:
            # inactive x: carry costs and backtrack through; at x==1 reset to
            # the costs at x and a zero delta
            inactive = ~bmask[None, :, :, x]
            new_pcost = torch.where(inactive, tcx if x == 1 else pcost, new_pcost)
            bd = torch.where(inactive, torch.zeros_like(bd) if x == 1 else prev, bd)
        pcost, prev = new_pcost, bd
        piTs[x - 1] = bd

    center = (tpitch - 1) // 2
    fpath = torch.zeros((b, l, w), dtype=torch.int32, device=dev)
    f = torch.zeros((1, b, l), dtype=torch.int64, device=dev)
    for bx in range(w - 2, -1, -1):
        idx = f + center
        # an index outside the directions reads direction 0, as the JAX
        # package's select chain does (costs never get there)
        idx = torch.where((idx >= 0) & (idx < tpitch), idx, torch.zeros_like(idx))
        f = f + piTs[bx].gather(0, idx).to(torch.int64)
        fpath[..., bx] = f[0].to(torch.int32)
    if bmask is not None:
        fpath = torch.where(bmask, fpath, torch.zeros_like(fpath))
    return fpath


def _tap(row: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """row[..., PAD + x + off[..., x]] with the position clamped into the
    padded row (the JAX package's edge-padded ``_select_multi``; clamped
    positions feed only lanes whose guarded four-tap branch is unused)."""
    w = off.shape[-1]
    x = torch.arange(w, device=off.device, dtype=torch.int64)
    idx = (PAD + x + off.to(torch.int64)).clamp(0, row.shape[-1] - 1)
    return row.gather(-1, idx)


def _output_nonhp(r3p, r1p, r1n, r3n, fpath, w, mdis: int):
    d = fpath.to(torch.int64)
    ad = d.abs()
    xs = torch.arange(w, device=d.device, dtype=torch.int64)
    g1p, g1n = _tap(r1p, d), _tap(r1n, -d)
    g3p, g3n = _tap(r3p, 3 * d), _tap(r3n, -3 * d)
    four_tap = 0.5625 * (g1p + g1n) - 0.0625 * (g3p + g3n)
    two_tap = (g1p + g1n) * 0.5
    ok = (xs >= ad * 3) & (xs + ad * 3 <= w - 1)
    return torch.where(ok, four_tap, two_tap)


def _output_hp(r3p, r1p, r1n, r3n, fpath, w, bmask, mdis: int):
    d = fpath.to(torch.int64)
    xs = torch.arange(w, device=d.device, dtype=torch.int64)
    even = (d & 1) == 0
    d2 = d >> 1
    ad_e = d2.abs()
    # torch's >> on negative integers floors, like Python's and the
    # reference's shift expressions
    g1p_e, g1n_e = _tap(r1p, d >> 1), _tap(r1n, -(d >> 1))
    g3p_e, g3n_e = _tap(r3p, (3 * d) >> 1), _tap(r3n, -((3 * d) >> 1))
    g3p_o = _tap(r3p, (3 * d + 1) >> 1)
    g1p_o, g1n_o = _tap(r1p, (d + 1) >> 1), _tap(r1n, -((d + 1) >> 1))
    g3n_o = _tap(r3n, -((3 * d + 1) >> 1))
    four_e = 0.5625 * (g1p_e + g1n_e) - 0.0625 * (g3p_e + g3n_e)
    two_e = (g1p_e + g1n_e) * 0.5
    ok_e = (xs >= ad_e * 3) & (xs + ad_e * 3 <= w - 1)
    out_e = torch.where(ok_e, four_e, two_e)

    d30 = (3 * d) >> 1
    d31 = (3 * d + 1) >> 1
    ad_o = torch.maximum(d30.abs(), d31.abs())
    c0 = g3p_e + g3p_o
    c1 = g1p_e + g1p_o
    c2 = g1n_e + g1n_o
    c3 = g3n_e + g3n_o
    four_o = 0.28125 * (c1 + c2) - 0.03125 * (c0 + c3)
    two_o = (c1 + c2) * 0.25
    ok_o = (xs >= ad_o) & (xs + ad_o <= w - 1)
    out_o = torch.where(ok_o, four_o, two_o)

    out = torch.where(even, out_e, out_o)
    if bmask is not None:
        vert = (0.5625 * (_take_pad(r1p, 0) + _take_pad(r1n, 0))
                - 0.0625 * (_take_pad(r3p, 0) + _take_pad(r3n, 0)))
        out = torch.where(bmask, out, vert)
    return out


def _build_bmask(maskp: torch.Tensor, mdis: int) -> torch.Tensor:
    """(B, L, W) mask -> bool gate (reference buildBmask)."""
    b, l, w = maskp.shape
    dev = maskp.device
    minmdis = min(w, mdis)
    xs = torch.arange(w, device=dev, dtype=torch.int64)
    nz = maskp.to(torch.int32) != 0
    none = torch.tensor(-666999, device=dev, dtype=torch.int64)
    # init: last = max over x < minmdis with mask[x]!=0 of (x + mdis)
    if minmdis > 0:
        last0 = torch.where(nz[:, :, :minmdis], xs[:minmdis] + mdis, none).amax(dim=2)
    else:
        last0 = torch.full((b, l), -666999, device=dev, dtype=torch.int64)
    # main: cummax over x'' of (x'' + 2*mdis) where mask[x''+mdis]!=0
    nmain = w - minmdis
    if nmain > 0:
        cand = torch.where(nz[:, :, mdis : mdis + nmain], xs[:nmain] + 2 * mdis, none)
        last_main = torch.maximum(torch.cummax(cand, dim=2).values, last0[:, :, None])
        bm_main = xs[:nmain] <= last_main
        last_end = last_main[:, :, -1]
    else:
        bm_main = torch.zeros((b, l, 0), dtype=torch.bool, device=dev)
        last_end = last0
    bm_tail = xs[nmain:] <= last_end[:, :, None]
    return torch.cat([bm_main, bm_tail], dim=2)


def _interp_all(rows4, mask, params, hp: bool, w: int):
    """The per-line pipeline for all lines at once: (out f32, fpath i32),
    each (B, L, w).  `mask` is the (B, L, w) mclip rows or None."""
    mdis, nrad, alpha, beta, gamma, one_minus_ab = params
    r3p, r1p, r1n, r3n = [_pad_rows(r).contiguous() for r in rows4]
    bm = _build_bmask(mask, mdis) if mask is not None else None
    if not hp:
        return kernels.eedi3_fused(r3p, r1p, r1n, r3n, w, mdis, nrad, alpha, beta,
                                   gamma, one_minus_ab, bm)
    if bm is None:
        return kernels.eedi3_fused_hp(r3p, r1p, r1n, r3n, w, mdis, nrad, alpha, beta,
                                      gamma, one_minus_ab)
    # hp with mclip: no kernel, the plain path on either device (masked-out
    # pixels fall back to the vertical 4-tap)
    tc = torch.stack(_costs_hp(r3p, r1p, r1n, r3n, mdis, nrad, alpha, beta,
                               one_minus_ab), dim=0)
    fpath = _dp(tc, bm, gamma, True)
    return _output_hp(r3p, r1p, r1n, r3n, fpath, w, bm, mdis), fpath


def _vcheck(src_lines, dst_lines, scp, dmap, field, n_interp, n_dst, n_src,
            dh, hp, vcheck, vthresh0, vthresh1, vthresh2, w, mdis):
    """Sequential reliability pass over interpolated lines (reference
    vcheckLine).  dst_lines (B, n_dst, W) already holds the interpolation.
    The per-line inputs are gathered here into (n_off, ...) tensors; the
    line-sequential sweep is kernel B10."""
    rcp0 = np.float32(1.0 / (vthresh0 / 255.0))
    rcp1 = np.float32(1.0 / (vthresh1 / 255.0))
    rcp2 = np.float32(1.0 / vthresh2)
    vt2 = np.float32(vthresh2)

    offs = np.arange(1, n_interp - 1)
    pds = field + 2 * offs
    # drop loop iterations the reference skips outright (only possible for
    # degenerate line counts)
    ok = (pds >= 2) & (pds + 2 < n_dst)
    offs, pds = offs[ok], pds[ok]
    if offs.size == 0:
        return dst_lines

    def dcol(delta):  # (n_off, B, W) strided view of dst rows pd+delta
        return dst_lines[:, pds[0] + delta : pds[-1] + delta + 1 : 2].transpose(0, 1)

    dl_a, d1p_a, d1n_a, d2n_a = dcol(0), dcol(-1), dcol(1), dcol(2)
    dm_c_a = dmap[:, offs[0] : offs[-1] + 1].transpose(0, 1)
    dm_p_a = dmap[:, offs[0] - 1 : offs[-1]].transpose(0, 1)
    dm_n_a = dmap[:, offs[0] + 1 : offs[-1] + 2].transpose(0, 1)
    if scp is not None:
        cint_a = scp[:, pds[0] : pds[-1] + 1 : 2].transpose(0, 1)
    else:
        dev = src_lines.device
        c3p = torch.tensor([_src_col(dh, int(p) - 3, n_src) for p in pds], device=dev)
        c3n = torch.tensor([_src_col(dh, int(p) + 3, n_src) for p in pds], device=dev)
        s3p_a = src_lines.index_select(1, c3p).transpose(0, 1)
        s3n_a = src_lines.index_select(1, c3n).transpose(0, 1)
        cint_a = 0.5625 * (d1p_a + d1n_a) - 0.0625 * (s3p_a + s3n_a)

    nb = torch.stack([d1p_a, d1n_a, d2n_a], dim=1).contiguous()
    dmst = torch.stack([dm_p_a, dm_c_a, dm_n_a], dim=1).to(torch.int32).contiguous()
    init = dst_lines[:, pds[0] - 2].contiguous()
    ys = kernels.vcheck(dl_a.contiguous(), nb, dmst, cint_a.contiguous(), init, w, mdis,
                        hp, vcheck, float(rcp0), float(rcp1), float(rcp2), float(vt2))
    out = dst_lines.clone()
    out[:, pds[0] : pds[-1] + 1 : 2] = ys.transpose(0, 1)
    return out


def _eedi3_plane(x, mask_plane, scp_plane, field: int, dh: bool, hp: bool,
                 mdis: int, nrad: int, alpha: float, beta: float, gamma: float,
                 vcheck: int, vthresh: tuple):
    """x: (B, n_src, W) f32; returns (B, n_dst, W)."""
    b, n_src, w = x.shape
    dev = x.device
    n_interp = n_src if dh else n_src // 2
    n_dst = n_src * 2 if dh else n_src

    one_minus_ab = np.float32(1.0) - np.float32(alpha) - np.float32(beta)
    a_s, b_s, g_s = alpha / 3.0, beta / 255.0, gamma / 255.0

    lines = [field + 2 * k for k in range(n_interp)]
    rows = []
    for off in (-3, -1, 1, 3):
        idx = torch.tensor([_src_col(dh, li + off, n_src) for li in lines], device=dev)
        rows.append(x.index_select(1, idx))
    mask_l = None
    if mask_plane is not None:
        # mask rows are picked at interp_off for dh, at the dst line otherwise
        midx = torch.tensor(list(range(n_interp)) if dh else lines, device=dev)
        mask_l = mask_plane.index_select(1, midx)

    params = (mdis, nrad, _f32(a_s), _f32(b_s), _f32(g_s), float(one_minus_ab))
    interp, fpath = _interp_all(rows, mask_l, params, hp, w)

    # assemble: kept lines + interpolated lines
    out = torch.zeros((b, n_dst, w), dtype=torch.float32, device=dev)
    out[:, (1 - field)::2] = x if dh else x[:, (1 - field)::2]
    out[:, field::2] = interp

    if vcheck > 0:
        out = _vcheck(x, out, scp_plane, fpath, field, n_interp, n_dst, n_src, dh, hp,
                      vcheck, vthresh[0], vthresh[1], vthresh[2], w, mdis)
    return out


def _eedi3_impl(horizontal: bool, clip: Clip, field: int, dh=False, alpha=0.2,
                beta=0.25, gamma=20.0, nrad=2, mdis=20, hp=False, vcheck=2,
                vthresh0=32.0, vthresh1=64.0, vthresh2=4.0,
                sclip: Clip | None = None, mclip: Clip | None = None) -> Clip:
    name = "EEDI3H" if horizontal else "EEDI3"
    axis_name = "width" if horizontal else "height"
    fmt = clip.format
    if fmt.sample_type is not SampleType.FLOAT or fmt.bits_per_sample != 32:
        raise VSZipError(f"{name}: only 32-bit float input is supported.")
    if field < 0 or field > 3:
        raise VSZipError(f"{name}: field must be 0, 1, 2, or 3.")
    if dh and field > 1:
        raise VSZipError(f"{name}: field must be 0 or 1 when dh=True.")
    interp_axis = clip.width if horizontal else clip.height
    if not dh and interp_axis % 2:
        raise VSZipError(f"{name}: {axis_name} must be mod 2 when dh=False.")
    if not (0.0 <= alpha <= 1.0):
        raise VSZipError(f"{name}: alpha must be between 0.0 and 1.0 (inclusive).")
    if not (0.0 <= beta <= 1.0):
        raise VSZipError(f"{name}: beta must be between 0.0 and 1.0 (inclusive).")
    if alpha + beta > 1.0:
        raise VSZipError(f"{name}: alpha + beta must be less than or equal to 1.0.")
    if gamma < 0.0:
        raise VSZipError(f"{name}: gamma must be greater than or equal to 0.0.")
    if not (0 <= nrad <= 3):
        raise VSZipError(f"{name}: nrad must be between 0 and 3 (inclusive).")
    if not (1 <= mdis <= 40):
        raise VSZipError(f"{name}: mdis must be between 1 and 40 (inclusive).")
    if not (0 <= vcheck <= 3):
        raise VSZipError(f"{name}: vcheck must be 0, 1, 2, or 3.")
    if vcheck > 0 and (vthresh0 <= 0 or vthresh1 <= 0 or vthresh2 <= 0):
        raise VSZipError(
            f"{name}: vthresh0, vthresh1 and vthresh2 must be greater than 0.0."
        )
    if mclip is not None:
        if mclip.format.color_family is not ColorFamily.GRAY:
            raise VSZipError(f"{name}: mclip must be Gray.")
        if (mclip.width, mclip.height) != (clip.width, clip.height):
            raise VSZipError(f"{name}: mclip's dimensions don't match.")
        if mclip.num_frames != clip.num_frames:
            raise VSZipError(f"{name}: mclip's number of frames doesn't match.")
        # the reference converts non-Gray8 masks to Gray8 (Resize.Point);
        # the gate only tests mask != 0, which is dtype-independent here
    double_rate = field > 1

    out_planes = []
    nf = clip.num_frames
    vthresh = (float(vthresh0), float(vthresh1), float(vthresh2))
    for p in range(fmt.num_planes):
        xp = clip.planes[p].to(torch.float32)
        mp = None
        if mclip is not None:
            # the single luma-sized Gray mask drives every plane; subsampled
            # planes read the first chroma-width pixels of the luma-indexed
            # mask rows (reference quirk: no scaling, plain row indexing)
            pw_, _ = clip.plane_dims(p)
            mp = mclip.planes[0][:, :, :pw_]
        if horizontal:
            xp = xp.transpose(1, 2)
            mp = mp.transpose(1, 2) if mp is not None else None

        def run(fld, scp_p):
            return _eedi3_plane(
                xp, mp, scp_p, fld, bool(dh), bool(hp), int(mdis), int(nrad),
                float(alpha), float(beta), float(gamma), int(vcheck), vthresh,
            )

        def sclip_plane():
            sp = sclip.planes[p].to(torch.float32)
            return sp.transpose(1, 2) if horizontal else sp

        base_field = field & 1
        if double_rate:
            scp_even = scp_odd = None
            if sclip is not None and vcheck > 0:
                sp = sclip_plane()
                scp_even, scp_odd = sp[0::2], sp[1::2]
            out0 = run(0 ^ base_field, scp_even)
            out1 = run(1 ^ base_field, scp_odd)
            res = torch.zeros((2 * nf,) + tuple(out0.shape[1:]), dtype=torch.float32,
                              device=out0.device)
            res[0::2] = out0
            res[1::2] = out1
        else:
            scp_p = sclip_plane() if sclip is not None and vcheck > 0 else None
            res = run(base_field, scp_p)
        if horizontal:
            res = res.transpose(1, 2)
        out_planes.append(res.contiguous())

    props = dict(clip.props)
    props["_FieldBased"] = 0
    return Clip(tuple(out_planes), fmt, props)


@spanned("vszip.op.eedi3")
def eedi3(clip: Clip, field: int, **kw) -> Clip:
    """vszip.EEDI3 (vertical interpolation)."""
    return _eedi3_impl(False, clip, field, **kw)


@spanned("vszip.op.eedi3h")
def eedi3h(clip: Clip, field: int, **kw) -> Clip:
    """vszip.EEDI3H (the same pipeline across the width)."""
    return _eedi3_impl(True, clip, field, **kw)
