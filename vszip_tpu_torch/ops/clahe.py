"""CLAHE: contrast-limited adaptive histogram equalization (OpenCV-style).

The PyTorch counterpart of ``vszip_tpu.ops.clahe`` (reference
src/filters/clahe.zig + src/vapoursynth/clahe.zig), with the same arguments,
messages and results.  8/16-bit int, all planes.  Per tile (tile_w =
width // tiles_x, tile_h = height // tiles_y; remainder pixels contribute to
no histogram but are still interpolated):

1. histogram, clipped at ``clip_limit = max(limit*tile_area//hist_size, 1)``;
   the clipped excess is redistributed: ``excess // hist_size`` to every bin,
   the residual to bins ``{k*step}`` with ``step = max(hist_size//residual,1)``;
2. LUT = ``trunc(cumsum * peak/tile_area + 0.5)``;
3. output = bilinear interpolation of the 4 neighbouring tile LUTs at the
   source value (tile coords ``x/tile_w - 0.5``, clamped), rounded half-up.

Stages 1-2 are plain torch on either device, as the JAX package computes
them in jnp outside Pallas; counts are exact int32 (a ``bincount`` over
``tile*hist_size + value``).  On 8-bit planes stage 3 is kernel B7
(``kernels/clahe.py``), fed the JAX package's 8-bit cell layout: the packed
table of the four neighbour LUTs per half-tile-shifted cell and the row and
column fractions, computed on the host in NumPy f32 exactly as the JAX
package does.  The 16-bit path gathers the four LUT entries per pixel in
plain torch.  Every blend rounds each f32 product and sum separately, the
reference's order.  Sets ``_ColorRange`` FULL.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.clip import Clip
from ..core.format import SampleType
from ..core.params import VSZipError, require
from ..kernels import clahe as kernels
from ..trace import spanned

FILTER_NAME = "CLAHE"


def _luts(x: torch.Tensor, limit: int, tiles_x: int, tiles_y: int,
          bits: int) -> torch.Tensor:
    """(n, tiles_y, tiles_x, hist_size) int32 LUTs of the covered region."""
    n, height, width = x.shape
    dev = x.device
    hist_size = 1 << bits
    peak = float(hist_size - 1)
    tile_w = width // tiles_x
    tile_h = height // tiles_y
    tile_area = tile_w * tile_h
    lut_scale = np.float32(peak / tile_area)
    clip_limit = max(limit * tile_area // hist_size, 1)
    n_tiles = tiles_y * tiles_x

    # --- per-tile histograms over the covered region (exact counts) ---
    nbins = n * n_tiles * hist_size
    it = torch.int32 if nbins < 2**31 else torch.int64
    xi = x[:, : tiles_y * tile_h, : tiles_x * tile_w].to(it)
    ty = torch.arange(tiles_y * tile_h, device=dev, dtype=it) // tile_h
    tx = torch.arange(tiles_x * tile_w, device=dev, dtype=it) // tile_w
    frame = torch.arange(n, device=dev, dtype=it).view(n, 1, 1) * n_tiles
    tile = frame + (ty.view(1, -1, 1) * tiles_x + tx.view(1, 1, -1))
    idx = tile * hist_size + xi
    hist = torch.bincount(idx.reshape(-1), minlength=nbins)
    hist = hist.view(n, n_tiles, hist_size).to(torch.int64)

    # --- clip + redistribute ---
    excess = (hist - clip_limit).clamp(min=0).sum(dim=-1, keepdim=True)
    hist = hist.clamp(max=clip_limit)
    batch = excess // hist_size
    residual = excess - batch * hist_size
    hist = hist + batch
    step = (hist_size // residual.clamp(min=1)).clamp(min=1)
    j = torch.arange(hist_size, device=dev, dtype=torch.int64)
    bump = ((j % step) == 0) & ((j // step) < residual)
    hist = hist + bump.to(torch.int64)

    # --- cumulative sum -> LUT ---
    cdf = torch.cumsum(hist, dim=-1)
    lut = torch.trunc(cdf.to(torch.float32) * float(lut_scale) + 0.5).to(torch.int32)
    return lut.view(n, tiles_y, tiles_x, hist_size)


def _cells_8bit(height: int, width: int, tile_h: int, tile_w: int,
                tiles_y: int, tiles_x: int):
    """The JAX package's 8-bit cell layout (vszip_tpu/ops/clahe.py:160-186):
    the plane shifted by half a tile splits into ry_n x rx_n cells, in each of
    which the four neighbour tiles are fixed.  Returns the neighbour tile
    indices per cell row/column and the row (ry_n, tile_h) and column
    (1, rx_n*tile_w) fractions, NumPy f32 exactly as written there."""
    thh, twh = tile_h // 2, tile_w // 2
    ry_n = -((thh + height) // -tile_h)
    rx_n = -((twh + width) // -tile_w)
    hp, wp = ry_n * tile_h, rx_n * tile_w
    ty1r = np.clip(np.arange(ry_n) - 1, 0, tiles_y - 1)
    ty2r = np.minimum(np.arange(ry_n), tiles_y - 1)
    tx1r = np.clip(np.arange(rx_n) - 1, 0, tiles_x - 1)
    tx2r = np.minimum(np.arange(rx_n), tiles_x - 1)
    ysp = (np.arange(hp) - thh).astype(np.float32)
    tyf = ysp * np.float32(1.0 / tile_h) - np.float32(0.5)
    ya = (tyf - np.floor(tyf)).astype(np.float32).reshape(ry_n, tile_h)
    xsp = (np.arange(wp) - twh).astype(np.float32)
    txf = xsp * np.float32(1.0 / tile_w) - np.float32(0.5)
    xa = (txf - np.floor(txf)).astype(np.float32).reshape(1, wp)
    return (ty1r, ty2r, tx1r, tx2r), ya, xa


def _lookup_inputs(lut: torch.Tensor, height: int, width: int, tiles_x: int,
                   tiles_y: int):
    """B7's inputs from the (n, tiles_y, tiles_x, 256) LUTs of an 8-bit
    plane: the packed table (n, ry_n, rx_n*256) int32 of the four neighbour
    LUTs per cell (one byte each), the row and column fractions as device
    tensors, and the tile size."""
    dev = lut.device
    n = lut.shape[0]
    tile_w = width // tiles_x
    tile_h = height // tiles_y
    (ty1r, ty2r, tx1r, tx2r), ya, xa = _cells_8bit(
        height, width, tile_h, tile_w, tiles_y, tiles_x)

    def sel(tyr, txr):  # (n, ry_n, rx_n, 256) int32 table per cell
        return lut[:, torch.from_numpy(tyr).to(dev)][:, :, torch.from_numpy(txr).to(dev)]

    tab32 = (sel(ty1r, tx1r) | (sel(ty1r, tx2r) << 8)
             | (sel(ty2r, tx1r) << 16) | (sel(ty2r, tx2r) << 24))
    tab32 = tab32.reshape(n, len(ty1r), len(tx1r) * lut.shape[-1]).contiguous()
    return (tab32, torch.from_numpy(ya).to(dev), torch.from_numpy(xa).to(dev),
            tile_h, tile_w)


def _clahe_plane(x: torch.Tensor, limit: int, tiles_x: int, tiles_y: int,
                 bits: int) -> torch.Tensor:
    n, height, width = x.shape
    dev = x.device
    hist_size = 1 << bits
    tile_w = width // tiles_x
    tile_h = height // tiles_y
    lut = _luts(x, limit, tiles_x, tiles_y, bits)

    if bits <= 8:
        return kernels.clahe8_lookup(x.contiguous(), *_lookup_inputs(
            lut, height, width, tiles_x, tiles_y))

    # --- 16-bit: bilinear interpolation of 4 tile LUTs per pixel ---
    xs = np.arange(width, dtype=np.float32)
    txf = xs * np.float32(1.0 / tile_w) - np.float32(0.5)
    tx1u = np.floor(txf)
    xa = torch.from_numpy((txf - tx1u).astype(np.float32)).to(dev).view(1, 1, width)
    tx1 = np.clip(tx1u, 0, tiles_x - 1).astype(np.int64)
    tx2 = np.minimum(tx1u + 1, tiles_x - 1).astype(np.int64)

    ys = np.arange(height, dtype=np.float32)
    tyf = ys * np.float32(1.0 / tile_h) - np.float32(0.5)
    ty1u = np.floor(tyf)
    ya = torch.from_numpy((tyf - ty1u).astype(np.float32)).to(dev).view(1, height, 1)
    ty1 = np.clip(ty1u, 0, tiles_y - 1).astype(np.int64)
    ty2 = np.minimum(ty1u + 1, tiles_y - 1).astype(np.int64)

    v = x.to(torch.int64)
    frame_base = (torch.arange(n, device=dev, dtype=torch.int64).view(n, 1, 1)
                  * (tiles_y * tiles_x * hist_size))
    lut_flat = lut.reshape(-1)

    def look(tyv, txv):
        tile = torch.from_numpy(tyv[:, None] * tiles_x + txv[None, :]).to(dev)
        return lut_flat[frame_base + tile[None] * hist_size + v].to(torch.float32)

    res = kernels.blend_bilinear(look(ty1, tx1), look(ty1, tx2), look(ty2, tx1),
                                 look(ty2, tx2), xa, ya)
    return res.to(torch.int32).to(x.dtype)


@spanned("vszip.op.clahe")
def clahe(clip: Clip, limit: int = 7, tiles=None) -> Clip:
    fmt = clip.format
    require(
        fmt.sample_type is SampleType.INTEGER and fmt.bits_per_sample in (8, 16),
        FILTER_NAME, "only 8 or 16 bit int formats supported.",
    )
    limit = int(limit)
    if tiles is None:
        tiles = [3, 3]
    elif not isinstance(tiles, (list, tuple)):
        tiles = [tiles]
    if len(tiles) < 1 or len(tiles) > 2:
        raise VSZipError(f"{FILTER_NAME} : tiles array can't have more than 2 values.")
    for t in tiles:
        if t < 1:
            raise VSZipError(f"{FILTER_NAME}: tiles values must be >= 1.")
    tiles_x = int(tiles[0])
    tiles_y = int(tiles[1]) if len(tiles) == 2 else tiles_x
    min_w = clip.width >> (fmt.subsampling_w if fmt.num_planes > 1 else 0)
    min_h = clip.height >> (fmt.subsampling_h if fmt.num_planes > 1 else 0)
    if tiles_x > min_w or tiles_y > min_h:
        raise VSZipError(
            f"{FILTER_NAME}: tiles must not exceed the (chroma) plane width/height."
        )
    hist_size = 1 << fmt.bits_per_sample
    cl = limit * (clip.width // tiles_x) * (clip.height // tiles_y) // hist_size
    if cl > 2**31 - 1:
        raise VSZipError(
            f"{FILTER_NAME}: limit too large for this frame size; reduce limit "
            "or increase tiles."
        )
    out = [_clahe_plane(p, limit, tiles_x, tiles_y, fmt.bits_per_sample)
           for p in clip.planes]
    return clip.with_planes(out).with_props(_ColorRange=0)
