#!/usr/bin/env python3
"""Where the port's hand-written CUDA kernels spend their time, by
``clock64()`` spans, on one NVIDIA GPU:

    python3 tools/kernel_spans.py                   # every kernel below
    python3 tools/kernel_spans.py ct_v_quant m2     # some of them

For each kernel it copies the library's source from ``vszip_tpu_torch/csrc/``,
inserts spans at fixed anchor lines of the kernel, builds the copy with the
package's nvcc flags into ``build/kernel_spans/``, and runs the package's
wrapper at the bench's shapes on the package's own build (timed by CUDA
events) and once on the copy, whose outputs must be equal.  It prints the
time, the mean cycles of each span, the resident blocks per SM
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) where the kernel
exports the query, and ptxas' registers of the package's build:

- ``eedi3_line`` (B8/B9, ``eedi3_line_kernel``) on 8 x 540 lines of w 1920,
  mdis 20, nrad 2, uniform random rows; non-hp, masked and hp: the block's
  time while the producer warps and the DP warp run, the DP warp's waits for
  a full cost buffer, producer warp 0's waits for an empty one and at the
  producers' end-of-chunk barrier, the backtrack and the interpolation;
- ``vcheck`` (B10, ``vcheck_kernel``) on 8 frames x 538 lines of w 1920,
  mdis 20, uniform random rows and directions in [-mdis, mdis] (hp
  2*mdis), mode 2: thread 0's cycles per line in waiting for the line's
  copies and the block's threads and issuing the next copies, in the line's
  values that do not need cur, in waiting for the neighbours' halo strips,
  and in finishing and storing its columns (on a line with a direction past
  the halo also the cluster barrier and those columns).  It also builds a copy with a
  cluster of one block (each frame's sweep on one block, the same ring and
  values ahead) and times it beside the package's build, outputs equal;
- ``subspl`` (B18, ``subspl_kernel``) at BilateralDither's defaults (r 16,
  k 30) on 64 frames of 1080p and 540x960 uint16: thread 0's cycles per
  block and frame group in the tile's fill, the taps and the divisions and
  stores, and the band shape;
- ``checkmate`` (B15, ``checkmate_kernel``) on 64 frames of 1080p and
  540x960 of the 8-bit picture of ``chip_smoke.py``, tthr2 0 and 10:
  thread 0's cycles per frame at the barrier before it, in issuing the
  next frame's copies and computing, and in waiting for the copies and
  widening them, and per block from its start to its first frame and to
  its end;
- ``v_fixed`` (B3 and B4, ``v_chip_kernel``) on the luma of 64 frames of
  1080p uint16, r 13 with 5 passes and r 23 with 1: lane 0's cycles per
  step (one input row) in issuing a group's copies, in waiting for a group
  and the warp, in the groups of 4 steps where no pass mirrors and in those
  at the edges;
- ``ct_v_quant`` (B1's vertical stage, ``ct_v_chip_kernel``) on the luma and
  a chroma plane of 64 frames of 1080p uint16, r 13: lane 0's cycles per
  step (one input row) in issuing a group's copies, in waiting for a group
  and the warp, in the groups of 4 steps that slide with no mirror and in
  those at the edges;
- ``ct_blur`` (B1 in one launch, ``ct_blur_kernel``) on the luma and a
  chroma plane of 64 frames of 1080p uint16, r 13: per group of rows, the
  horizontal half's thread 0 in waiting for the group's set of row buffers
  and in its warp's pair of rows (the margins, the first run and W(0); the
  runs; both rows out), and the vertical half's first thread in waiting for
  the group's rows and for an empty set, in the vertical sums, at the
  half's barrier and in issuing a group's copies;
- ``m2`` (B6, ``m2_tile_kernel``) on the 3 launches of ``deband(c)`` on 64
  frames of 1080p YUV420P16 (range 15): lane 0's cycles per pair of frames
  in decoding a tile's keys, in the taps, centres and stores, in waiting
  for the next pair's copies, at the two block barriers, in interleaving
  the next pair into the pair tile and in issuing the copies of the pair
  after; and each launch timed on a copy whose taps all read the centre
  (no bank conflicts, outputs not compared);
- ``comb_mask`` (B16, ``comb_mask_kernel``) at CombMask's defaults (metric
  0, cthresh 6, mthresh 9, expand) on 64 frames of 1080p and 540x960 of the
  8-bit picture: lane 0's cycles per frame in loading the band's rows and
  waiting for them, in the band's rows, and the warp's life per frame;
- ``ssim`` (B13, ``ssim_band_kernel``) on each of the 11 launches of
  ``ssimulacra2(r1, r2)`` on 8 frames of 1080p RGBS (r2 = r1 + 0.01), by
  (scale, plane), each timed alone (device time, ``torch.profiler``) with
  the launcher's variant and with each of the two forced, then the sum by
  scale: lane 0's cycles per warp (its 8 rows) in the vertical taps, in
  the horizontal pass and maps, in the window's shift and the next row's
  loads, in rows within 4 of the top or bottom, at the block barrier, in
  the in-order sums, and the warp's life; then the whole row's device time
  with the launcher's variant and with each forced, and both variants on
  2 to 32 frames of 270x480 planes, across the launcher's threshold;
- ``compress`` (B14, ``compress_kernel``) on 64 frames of 1080p and 540x960
  of the 8-bit picture, MPEG-2 q8 and JPEG q95 (the rows' regimes, luma
  and chroma tables): lane 0's cycles per block and frame in issuing the
  next frame's loads, in the block's pipeline and in the store, the
  thread's life per frame, and the share of IDCT rows, and of warps, that
  take the DC-only path;
- ``clahe8`` (B7, ``clahe8_chunk_kernel``) on the launch of ``clahe(c)`` on
  64 frames of 1080p GRAY8 noise (3x3 tiles): thread 0's cycles per row of
  its 16-byte chunk in staging frames' tables and their barriers, in
  filling the chunk's column table, in waiting for the row's chunk (loaded a
  row ahead) and in the 16 pixels' lookups, blends and packing, and the
  block's life; with the table loads' bank wavefronts a warp, counted from
  the data's bytes for the kernel's lanes (``bank_wavefronts``);
- ``luma_stats`` (B11, ``luma_warp_kernel``) on the luma of 32 frames of
  1080p 10-bit noise, order 1 (the row's), order 2 and temporal off: lane
  0's cycles per row step of each warp in waiting for the step's loads and
  unpacking and shuffling them, in shifting the loads in flight and issuing
  the next, in sse, the Laplacian and the temporal term, the block
  reduction, the prologue and the warp's life;
- ``chroma_sse`` (B12, ``chroma_strip_kernel``) on both chroma planes of
  that clip in one launch (the row's) and on one, 32x32 blocks, timed by the
  kernel's device time (``torch.profiler``; events around back-to-back calls
  measure the host at this size): lane 0's cycles per group of
  ``kRowsAhead`` rows of each warp in issuing the group's loads, in waiting
  for them and summing the rows, and per group the segmented reduction and
  store and the warp's life;

For B18, B15, B3/B4, B1's vertical stage, B1 in one launch, B6, B16, B13,
B14, B7, B11 and B12 it also
prints the instruction mix of each instantiation and of each of its loops
(``cuobjdump -sass`` of the
package's build), with the counts by class (f32, integer and address,
loads, stores, other).

The anchors are lines of the current sources; an older commit's kernels
are read with that commit's tool (``git show <commit>:tools/...``).
"""

import ctypes
import importlib
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from vszip_tpu_torch import _build  # noqa: E402
from vszip_tpu_torch.kernels import bilateral_dither as kbd  # noqa: E402
from vszip_tpu_torch.kernels import boxblur as kb  # noqa: E402
from vszip_tpu_torch.kernels import checkmate as kk  # noqa: E402
from vszip_tpu_torch.kernels import clahe as kc  # noqa: E402
from vszip_tpu_torch.kernels import comb_mask as km  # noqa: E402
from vszip_tpu_torch.kernels import compress as kz  # noqa: E402
from vszip_tpu_torch.kernels import deband as kd  # noqa: E402
from vszip_tpu_torch.kernels import eedi3 as ke  # noqa: E402
from vszip_tpu_torch.kernels import ssim as kss  # noqa: E402
from vszip_tpu_torch.kernels import xpsnr as kx  # noqa: E402
from vszip_tpu_torch.ops.eedi3 import _pad_rows  # noqa: E402

OUT = ROOT / "build" / "kernel_spans"
SLOTS = 12  # the probe's counters: the spans, and the count they are divided by last
FRAMES, LINES, W, MDIS, NRAD = 8, 538, 1920, 20, 2
EEDI3_COEFS = tuple(float(np.float32(v)) for v in (0.2 / 3, 0.25 / 255, 20.0 / 255)) + (
    float(np.float32(1.0) - np.float32(0.2) - np.float32(0.25)),)
RCP = (7.96875, 3.984375, 0.25, 4.0)  # vcheck's reciprocals and vthresh2 (32, 64, 4)


T0 = "threadIdx.x == 0 && threadIdx.y == 0"
LANE0 = "(threadIdx.x & 31) == 0"  # every warp's lane 0


def _span(var: str) -> str:
    """Code that adds the cycles since ``mt_a`` to `var` and restarts ``mt_a``."""
    return f"{{ const long long mt_b = clock64(); {var} += mt_b - mt_a; mt_a = mt_b; }}\n"


def _add(slot: int, value: str, who: str = "threadIdx.x == 0") -> str:
    return f"if ({who}) atomicAdd(&g_span[{slot}], (unsigned long long)({value}));"


# kernel -> (library, span names, ((anchor, code before,
# code after), ...), the C entry `vz_probe_occupancy(a, b, c, blocks,
# threads)` or "")
KERNELS = {
    "eedi3_line": ("eedi3", (
        "roles (producers and DP)", "DP waits for costs", "producer 0 waits for a buffer",
        "producer 0 waits at chunk end", "backtrack", "interpolation"), (
        ("    if (c > 0) bar_sync_pair<kBarFull, Sh::threads>(buf);\n",
         "    const long long ph_w = clock64();\n", ""),
        ("    const float* Cb = C + buf * kXc * tp + t0;\n",
         f"    {_add(1, 'clock64() - ph_w', 'lane == 0')}\n", ""),
        ("    if (c >= 2) bar_sync_pair<kBarEmpty, Sh::threads>(buf);  "
         "// the DP is done with chunk c-2\n", "    const long long ph_e = clock64();\n", ""),
        ("    const int x0 = c * kXc, cn = min(kXc, w - x0);\n"
         "    float* Cb = C + buf * kXc * tp;\n",
         f"    {_add(2, 'clock64() - ph_e')}\n", ""),
        ("    cp_async_wait_all();  // chunk c+1's windows are in; nobody reads chunk c's "
         "any more\n",
         "    const long long ph_p = clock64();\n", ""),
        ("    if (threadIdx.x == 0) queue[buf] = 0;  // for chunk c+2\n",
         f"    {_add(3, 'clock64() - ph_p')}\n", ""),
        ("  if (warp < Sh::prod) {\n", "  long long ph_m = clock64();\n", ""),
        ("  // ---- backtrack by chunks: fpath[w-1] = 0, fpath[x-1] = f(x) + delta(x) ----\n",
         f"  {_add(0, 'clock64() - ph_m')}\n  ph_m = clock64();\n", ""),
        ("  // ---- directional interpolation ----\n",
         f"  {_add(4, 'clock64() - ph_m')}\n  ph_m = clock64();\n", ""),
        ("      orow[x] = res;\n    }\n  }\n", "",
         f"  __syncthreads();\n  {_add(5, 'clock64() - ph_m')}\n  {_add(SLOTS - 1, '1')}\n")), """
extern "C" int vz_probe_occupancy(int w, int mdis, int variant, int* blocks, int* threads) {
  const bool hp = variant == 2;
  const Plan P = plan(w, mdis, hp);
  const size_t bytes = P.base_bytes + (P.bt_smem ? 4 * (size_t)P.bt_words : 0);
  const void* k = hp ? (const void*)eedi3_line_kernel<true, false, 3>
                     : variant == 1 ? (const void*)eedi3_line_kernel<false, true, 2>
                                    : (const void*)eedi3_line_kernel<false, false, 2>;
  *threads = hp ? Shape<true>::threads : Shape<false>::threads;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, *threads, bytes);
}
"""),
    "vcheck": ("eedi3", (
        "copies in, block sync, next copies issued", "values ahead of cur",
        "neighbours' halo wait", "finish and store (far lines: the barrier and far columns)"), (
        ("  const size_t fb = (size_t)b * w;\n", "",
         "  long long sp_a = 0, sp_b = 0, sp_c = 0, sp_d = 0;\n"),
        ("    cp_async_wait_pending(pl.ring - 2);\n    __syncthreads();\n",
         "    long long sp0 = clock64();\n", ""),
        ("    VcheckPre v[kCols];\n", "    long long sp1 = clock64();\n", ""),
        ("    if (li > 0) {\n      // the neighbours' columns of line li-1 have landed in cur\n",
         "    long long sp2 = clock64();\n", ""),
        ("    unsigned far_cols = 0;  // bit k: column k reaches past the halo\n",
         "    long long sp3 = clock64();\n", ""),
        ("    float* t = cur;\n    cur = nxt;\n    nxt = t;\n  }\n  // no block leaves",
         "    if (tid == 0) { sp_a += sp1 - sp0; sp_b += sp2 - sp1; sp_c += sp3 - sp2; "
         "sp_d += clock64() - sp3; }\n", ""),
        ("  // no block leaves while a neighbour may still address it\n",
         f"  {_add(0, 'sp_a')} {_add(1, 'sp_b')} {_add(2, 'sp_c')} {_add(3, 'sp_d')} "
         f"{_add(SLOTS - 1, 'n_off')}\n", "")), ""),
    "v_fixed": ("boxblur", (
        "issue a copy group", "wait for a group and the warp", "groups of 4 steps where no "
        "pass mirrors", "groups at the edges (top, bottom)"), (
        ("  int c0 = 0, t0 = R0 - R, cr = 0;  // s mod R0, (s - R) mod R0, s mod R\n", "",
         "  long long vc_issue = 0, vc_wait = 0, vc_steady = 0, vc_edge = 0;\n"),
        ("    if (s0 < h) {\n      __syncwarp();  // every lane is done with the rows the copies "
         "overwrite\n", "", "      const long long vc0 = clock64();\n"),
        ("      st.issue(s0 / kGroupRows + kAheadGroups);\n", "",
         "      const long long vc1 = clock64();\n"),
        ("      __syncwarp();  // rows s0 .. s0+3 are in ring 0, for every lane\n", "",
         "      vc_issue += vc1 - vc0;\n      vc_wait += clock64() - vc1;\n"),
        ("    if (s0 >= s_steady && s0 + kGroupRows <= h) {\n",
         "    const long long vc2 = clock64();\n"
         "    const bool vc_st = s0 >= s_steady && s0 + kGroupRows <= h;\n", ""),
        ("          edge(s);\n        }\n        advance();\n      }\n    }\n", "",
         "    (vc_st ? vc_steady : vc_edge) += clock64() - vc2;\n"),
        ("}\n\n// h_fixed's shape for a row of w samples",
         f"  {_add(0, 'vc_issue')} {_add(1, 'vc_wait')} {_add(2, 'vc_steady')} "
         f"{_add(3, 'vc_edge')} {_add(SLOTS - 1, 'S')}\n", "")), """
extern "C" int vz_probe_occupancy(int r, int passes, int unused, int* blocks, int* threads) {
  const void* k = passes == 5 ? (const void*)v_chip_kernel<uint16_t, 5, true>
                              : (const void*)v_chip_kernel<uint16_t, 1, true>;
  *threads = 32;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)v_chip_bytes(r, passes));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, 32,
                                                            v_chip_bytes(r, passes));
}
"""),
    "ct_v_quant": ("boxblur", (
        "issue a copy group", "wait for a group and the warp", "groups of 4 steps that slide "
        "with no mirror", "groups at the edges (W(0), top, bottom)"), (
        ("  int c0 = 0, t0 = R0 - R;  // s mod R0, (s - R) mod R0\n", "",
         "  long long ct_issue = 0, ct_wait = 0, ct_steady = 0, ct_edge = 0;\n"),
        ("      st.issue(j0 / kGroupRows + kAheadGroups);\n",
         "      const long long ct0 = clock64();\n", ""),
        ("      if (kVec) cp_async_wait<kAheadGroups>();\n"
         "      __syncwarp();  // rows j0 .. j0+3 are in the ring, for every lane\n",
         "      const long long ct1 = clock64();\n",
         "      ct_issue += ct1 - ct0;\n      ct_wait += clock64() - ct1;\n"),
        ("    if (j0 >= R && j0 + kGroupRows <= h) {\n",
         "    const long long ct2 = clock64();\n"
         "    const bool ct_st = j0 >= R && j0 + kGroupRows <= h;\n", ""),
        ("          edge(j);\n        }\n        advance();\n      }\n    }\n", "",
         "    (ct_st ? ct_steady : ct_edge) += clock64() - ct2;\n"),
        ("}\n\nvoid fixed_constants(",
         f"  {_add(0, 'ct_issue')} {_add(1, 'ct_wait')} {_add(2, 'ct_steady')} "
         f"{_add(3, 'ct_edge')} {_add(SLOTS - 1, 'S')}\n", "")), """
extern "C" int vz_probe_occupancy(int r, int unused, int unused2, int* blocks, int* threads) {
  const void* k = (const void*)ct_v_chip_kernel<uint16_t, true>;
  *threads = 32;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)v_chip_bytes(r, 1));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, 32, v_chip_bytes(r, 1));
}
"""),
    "ct_blur": ("boxblur", (
        "H: wait for the group's set", "H: margins, first run, W(0)", "H: the runs",
        "H: both rows out", "V: wait for the group's rows", "V: wait for an empty set",
        "V: the vertical sums", "V: the half's barrier", "V: issue a group's copies"), (
        ("  if (warp >= P) {\n    // ---- the vertical half ----\n",
         "  long long cb_s[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0}, cb_groups = 0, mt_a;\n", ""),
        ("    for (int Y = y0, g = 0; Y < y1; Y += G, ++g) {\n      const int set = g & 1;\n"
         "      landed(g + 1);  // rows up to Y + G + r are in the ring\n",
         "    mt_a = clock64();\n", "      " + _span("cb_s[4]")),
        ("      if (g >= 2) named_sync(kEmpty + set, 2 * kHalf);"
         "  // group g-2 is out of the set\n", "", "      " + _span("cb_s[5]")),
        ("      named_arrive(kFull + set, 2 * kHalf);  // the group is in the set\n",
         "      " + _span("cb_s[6]"), ""),
        ("      named_sync(kVertical, kHalf);          // and done with its trail rows\n", "",
         "      " + _span("cb_s[7]")),
        ("      copy(G);                               // into their slots\n", "",
         "      " + _span("cb_s[8]")),
        ("    return;\n  }\n\n  // ---- the horizontal half ----\n",
         "    " + " ".join(_add(i, f"cb_s[{i}]", "threadIdx.x == blockDim.x / 2")
                          for i in range(4, 9)) + "\n", ""),
        ("  for (int Y = y0, g = 0; Y < y1; Y += G, ++g) {\n    const int set = g & 1;\n"
         "    named_sync(kFull + set, 2 * kHalf);  // the group is in the set\n",
         "  mt_a = clock64();\n", "    " + _span("cb_s[0]")),
        ("#pragma unroll 1\n      for (int c = 0; c < cf.chunks && p < live; ++c, p += n) {\n",
         "      " + _span("cb_s[1]"), ""),
        ("      __syncwarp();\n      // both rows out", "      " + _span("cb_s[2]"), ""),
        ("    if (g + 2 < groups) named_arrive(kEmpty + set, 2 * kHalf);  // the set is free\n",
         "    " + _span("cb_s[3]") + "    ++cb_groups;\n", ""),
        ("  }\n}\n\nvoid fixed_constants(",
         "  " + " ".join(_add(i, f"cb_s[{i}]") for i in range(4)) + " "
         + _add(SLOTS - 1, "cb_groups") + "\n", "")), ""),
    "comb_mask": ("comb_mask", (
        "load the band's rows and halo and wait", "the band's rows: comb, motion, expand, store",
        "the warp's life, per frame"), (
        ("  if (xo >= w) return;  // the whole warp\n", "",
         "  const long long cm0 = clock64();\n  long long cm_load = 0, cm_rows = 0, cm_n = 0;\n"),
        ("        load_band<kAligned>(cur, src + f * plane, y0, x, h, w);\n",
         "        const long long ct0 = clock64();\n",
         "        {\n          uint32_t dep;\n"
         "          asm volatile(\"mov.b32 %0, 0;\" : \"=r\"(dep));\n"
         "#pragma unroll\n          for (int j = 0; j < kBand + 4; ++j) dep ^= cur[j];\n"
         "          asm volatile(\"\" ::\"r\"(dep));\n        }\n"
         "        const long long ct1 = clock64();\n        cm_load += ct1 - ct0;\n"),
        ("        if (kMotion) {\n#pragma unroll\n          for (int j = 0; j < kBand + 4; ++j) "
         "prev[j] = cur[j];\n        }\n",
         "        cm_rows += clock64() - ct1;\n        ++cm_n;\n", ""),
        ("}\n\ntemplate <bool kMetric1, bool kMotion, bool kAligned>\nvoid launch(",
         f"  {_add(0, 'cm_load', LANE0)} {_add(1, 'cm_rows', LANE0)} "
         f"{_add(2, 'clock64() - cm0', LANE0)} {_add(SLOTS - 1, 'cm_n', LANE0)}\n", "")), """
extern "C" int vz_probe_occupancy(int metric_1, int motion, int aligned, int* blocks,
                                  int* threads) {
  const void* k = metric_1 ? (const void*)comb_mask_kernel<true, true, true>
                           : (motion ? (const void*)comb_mask_kernel<false, true, true>
                                     : (const void*)comb_mask_kernel<false, false, true>);
  *threads = 32 * kWarps;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, 32 * kWarps, 0);
}
"""),
    "m2": ("deband", (
        "decode an item's keys", "taps, centres and stores", "wait for the next pair's copies",
        "block barriers (2)", "interleave the next pair into the pair tile",
        "issue the copies of the pair after"), (
        ("  if (1 < steps) stage(1);\n", "",
         "  long long mt_dec = 0, mt_comp = 0, mt_wait = 0, mt_bar = 0, mt_il = 0, mt_stage = 0,\n"
         "            mt_n = 0;\n"),
        ("    const bool second = f + 1 < n;\n", "", "    long long mt_a = clock64();\n"),
        ("    if (t != cur) {\n      decode(t);\n      cur = t;\n    }\n", "",
         "    " + _span("mt_dec")),
        ("    if (k + 1 < steps) {\n      cp_async_wait_all();\n",
         "    " + _span("mt_comp") + "    ++mt_n;\n", "      " + _span("mt_wait")),
        ("      __syncthreads();  // this pair's tile is read, the next pair's frames are in\n",
         "", "      " + _span("mt_bar")),
        ("      __syncthreads();  // the next pair's tile is in; the frame tiles are free\n",
         "      " + _span("mt_il"), "      " + _span("mt_bar")),
        ("      if (k + 2 < steps) stage(k + 2);\n", "", "      " + _span("mt_stage")),
        ("}\n\ndim3 tile_grid(int h, int w) {",
         f"  {_add(0, 'mt_dec', LANE0)} {_add(1, 'mt_comp', LANE0)} {_add(2, 'mt_wait', LANE0)} "
         f"{_add(3, 'mt_bar', LANE0)} {_add(4, 'mt_il', LANE0)} {_add(5, 'mt_stage', LANE0)} "
         f"{_add(SLOTS - 1, 'mt_n', LANE0)}\n", "")), """
extern "C" int vz_probe_occupancy(int rmax, int unused, int unused2, int* blocks, int* threads) {
  const void* k = (const void*)m2_tile_kernel<true, true>;
  *threads = kM2Threads;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kMaxSmemBytes);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, kM2Threads,
                                                            M2Tile(rmax).bytes());
}
"""),
    "subspl": ("bilateral_dither", (
        "fill and its barriers", "taps", "division and store"), (
        ("  const int rows = min(b.rows, p.h - y0);\n", "",
         "  long long sb_fill = 0, sb_taps = 0, sb_out = 0, sb_n = 0;\n"),
        ("    __syncthreads();  // the previous frames' taps are read (and the table is in)\n",
         "    const long long sb0 = clock64();\n", ""),
        ("    fill_band<T, kRef, kVec>(tile, src, ref, f0, ox, y0, p, b);\n    __syncthreads();\n",
         "", "    sb_fill += clock64() - sb0;\n    ++sb_n;\n"),
        ("      float acc0 = 0.f, accw0 = 0.f, acc1 = 0.f, accw1 = 0.f;\n",
         "      const long long sb1 = clock64();\n", ""),
        ("        tap_e(t1[lo1[j]], cen1, cref1, p, acc1, accw1);\n      }\n", "",
         "      const long long sb2 = clock64();\n      sb_taps += sb2 - sb1;\n"),
        ("        if (r1 > rr) put(o + p.w, cen1 + acc1 / fmaxf(accw1, p.swmin), p.peak);\n"
         "      }\n", "", "      sb_out += clock64() - sb2;\n"),
        ("}\n\nsize_t tile_bytes(",
         f"  {_add(0, 'sb_fill')} {_add(1, 'sb_taps')} {_add(2, 'sb_out')} "
         f"{_add(SLOTS - 1, 'sb_n')}\n", "")), ""),
    "checkmate": ("checkmate", (
        "barrier before the frame", "next copies issued, 16 pixels computed",
        "copies waited for, barrier, widening", "the block's life, from its start",
        "from its start to its first frame"), (
        ("                 8192 / tmax, tthr2};\n", "",
         "  long long cs_bar = 0, cs_comp = 0, cs_wid = 0, cs_n = 0, cs_pro = 0;\n"
         "  const long long cs_start = clock64();\n"),
        ("      __syncthreads();  // frame f+W is widened, frame f-1 computed, the raw tile free\n",
         "      const long long cs0 = clock64();\n      if (cs_n == 0) cs_pro = cs0 - cs_start;\n",
         "      const long long cs1 = clock64();\n      cs_bar += cs1 - cs0;\n"),
        ("                                out + f * plane, h, w, x0, y0, k);\n", "",
         "      const long long cs2 = clock64();\n      cs_comp += cs2 - cs1;\n"),
        ("        widen<kAligned>(slot(f + W + 1), raw, w, x0);\n      }\n", "",
         "      cs_wid += clock64() - cs2;\n      ++cs_n;\n"),
        ("}\n\ntemplate <bool kTthr2, bool kAligned>\nint launch(",
         f"  {_add(0, 'cs_bar')} {_add(1, 'cs_comp')} {_add(2, 'cs_wid')} "
         f"{_add(3, 'cs_n * (clock64() - cs_start)')} {_add(4, 'cs_n * cs_pro')} "
         f"{_add(SLOTS - 1, 'cs_n')}\n", "")), """
extern "C" int vz_probe_occupancy(int tthr2, int aligned, int unused, int* blocks, int* threads) {
  const void* k = tthr2 ? (aligned ? (const void*)checkmate_kernel<true, true>
                                   : (const void*)checkmate_kernel<true, false>)
                        : (aligned ? (const void*)checkmate_kernel<false, true>
                                   : (const void*)checkmate_kernel<false, false>);
  *threads = kThreads;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem_bytes(tthr2));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, kThreads,
                                                            smem_bytes(tthr2));
}
"""),
    "ssim": ("ssim", (
        "vertical pass (the window's taps)", "horizontal pass and maps (two warp barriers)",
        "window shift and the next row's loads", "rows within 4 of the top or bottom",
        "block barrier", "in-order sums of the band", "the warp's life"), (
        ("  const int ys = y0 + warp * kWarpRows, ye = min(ys + kWarpRows, y1);\n", "",
         "  long long sn_v = 0, sn_h = 0, sn_s = 0, sn_e = 0;\n"
         "  const long long sn_start = clock64();\n"),
        ("      float v[4][kCols];\n#pragma unroll\n      for (int k = 0; k < kTaps; ++k) "
         "vtap<kSsim, kCols>(v, P[k], Q[k], k);\n", "      const long long sn0 = clock64();\n",
         "      const long long sn1 = clock64();\n"),
        ("      row_maps<kSsim, kErr, kCols>(B, y - y0, v, P[kRadius], Q[kRadius]);\n", "",
         "      const long long sn2 = clock64();\n"),
        ("          Q[kTaps - 1][j] = nq[j];\n        }\n      }\n", "",
         "      sn_v += sn1 - sn0;\n      sn_h += sn2 - sn1;\n      sn_s += clock64() - sn2;\n"),
        ("  } else if (ys < ye) {\n", "", "    const long long sn3 = clock64();\n"),
        ("      row_maps<kSsim, kErr, kCols>(B, y - y0, v, pc, qc);\n    }\n", "",
         "    sn_e += clock64() - sn3;\n"),
        ("  __syncthreads();\n\n  // one thread per (sum pair, column)",
         "  const long long sn4 = clock64();\n", ""),
        ("  // one thread per (sum pair, column): the band's rows in row order.  The\n",
         "  const long long sn5 = clock64();\n", ""),
        ("      dst[w] = 0.0f;\n    }\n  }\n", "",
         f"  {_add(0, 'sn_v', LANE0)} {_add(1, 'sn_h', LANE0)} {_add(2, 'sn_s', LANE0)}\n"
         f"  {_add(3, 'sn_e', LANE0)} {_add(4, 'sn5 - sn4', LANE0)}\n"
         f"  {_add(5, 'clock64() - sn5', LANE0)} {_add(6, 'clock64() - sn_start', LANE0)}\n"
         f"  {_add(SLOTS - 1, '1', LANE0)}\n")), """
template <int kCols>
int probe_occupancy(int ssim, int err, int* blocks) {
  const void* k = ssim ? (err ? (const void*)ssim_band_kernel<true, true, kCols>
                              : (const void*)ssim_band_kernel<true, false, kCols>)
                       : (const void*)ssim_band_kernel<false, true, kCols>;
  const size_t bytes = ssim ? (err ? smem_bytes<true, true, kCols>(64)
                                   : smem_bytes<true, false, kCols>(64))
                            : smem_bytes<false, true, kCols>(64);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, kMaxThreads, bytes);
}

extern "C" int vz_probe_occupancy(int ssim, int err, int cols, int* blocks, int* threads) {
  *threads = kMaxThreads;
  return cols == 2 ? probe_occupancy<2>(ssim, err, blocks) : probe_occupancy<1>(ssim, err, blocks);
}
"""),
    "clahe8": ("clahe", (
        "table staging and its barriers", "the chunk's column table",
        "wait for the row's chunk (loaded a row ahead)", "16 pixels: lookups, blend, pack",
        "the block's life"), (
        ("  extern __shared__ int32_t stab[];\n", "",
         "  long long cs_stage = 0, cs_cols = 0, cs_wait = 0, cs_pix = 0, cs_n = 0;\n"
         "  uint32_t cs_dep = 0;\n  const long long cs_start = clock64();\n"),
        ("    if (kSmem) {\n      __syncthreads();  // every thread is done with the previous frame's "
         "table\n", "    const long long cs0 = clock64();\n", ""),
        ("    for (int cc = tx; cc < chunks; cc += bx) {\n", "    cs_stage += clock64() - cs0;\n", ""),
        ("      const int c0 = cc * kChunk, valid = w - c0;\n", "",
         "      const long long cs_c0 = clock64();\n"),
        ("      int y = ys + ty;\n",
         "#pragma unroll\n      for (int j = 0; j < kChunk; ++j) cs_dep ^= (uint32_t)col[j] ^ "
         "__float_as_uint(ofx[j]);\n      cs_cols += clock64() - cs_c0;\n", ""),
        ("        const float fy = __ldg(ya + py);\n",
         "        const long long cs2 = clock64();\n        cs_dep ^= cur[0] ^ cur[1] ^ cur[2] ^ "
         "cur[3];\n        const long long cs3 = clock64();\n", ""),
        ("        store_chunk<kVec>(dst, o, valid);\n",
         "        cs_dep ^= o[0] ^ o[3];\n        const long long cs4 = clock64();\n"
         "        cs_wait += cs3 - cs2;\n        cs_pix += cs4 - cs3;\n        ++cs_n;\n", ""),
        ("        for (int i = 0; i < 4; ++i) cur[i] = nxt[i];\n      }\n    }\n  }\n", "",
         f"  {_add(0, 'cs_stage')} {_add(1, 'cs_cols')} {_add(2, 'cs_wait')} {_add(3, 'cs_pix')}\n"
         f"  {_add(4, 'clock64() - cs_start')} {_add(10, 'cs_dep == 0x1234567u')} "
         f"{_add(SLOTS - 1, 'cs_n')}\n")), """
extern "C" int vz_probe_occupancy(int nthreads, int smem, int vec, int* blocks, int* threads) {
  *threads = nthreads;
  const void* k = smem ? (const void*)clahe8_chunk_kernel<true, 16>
                       : (const void*)clahe8_chunk_kernel<false, 16>;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kSmemTableBytes);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, *threads,
                                                            smem ? 16 * 1024 : 0);
}
"""),
    "luma_stats": ("xpsnr", (
        "prologue: the first rows' loads", "wait for this step's loads, unpack and shuffle",
        "shift the loads in flight, issue the next", "sse, Laplacian, temporal term",
        "block reduction and store", "the warp's life"), (
        ("  const int lane = threadIdx.x & 31;\n", "",
         "  long long ls_wait = 0, ls_issue = 0, ls_comp = 0, ls_red = 0, ls_n = 0;\n"
         "  uint32_t ls_dep = 0;\n  const long long ls_start = clock64();\n"),
        ("  for (int b = by0; b < by1; ++b) {\n", "  const long long ls_pro = clock64() - ls_start;\n",
         ""),
        ("    for (int y = b * kLumaBlock; y < ye; ++y) {\n", "",
         "      const long long ls0 = clock64();\n"),
        ("      // ... and issue step y+kAhead's loads\n",
         "      ls_dep ^= (uint32_t)(dn.va ^ dn.hb ^ ra ^ rb ^ qa ^ qb);\n"
         "      const long long ls1 = clock64();\n", ""),
        ("      const int da = mid.ca - ra, db = mid.cb - rb;\n",
         "      const long long ls2 = clock64();\n", ""),
        ("      vup_a = mid.va;\n",
         "      ls_dep ^= (uint32_t)sse ^ sa ^ ta;\n      const long long ls3 = clock64();\n"
         "      ls_wait += ls1 - ls0;\n      ls_issue += ls2 - ls1;\n      ls_comp += ls3 - ls2;\n"
         "      ++ls_n;\n", ""),
        ("    const unsigned long long t0 = warp_total(sse);\n",
         "    const long long ls4 = clock64();\n", ""),
        ("      out[2 * stride + blk] = t2;\n    }\n", "", "    ls_red += clock64() - ls4;\n"),
        ("}\n\ntemplate <typename T, bool kPair>\nint launch_luma(",
         f"  {_add(0, 'ls_pro', LANE0)} {_add(1, 'ls_wait', LANE0)} {_add(2, 'ls_issue', LANE0)}\n"
         f"  {_add(3, 'ls_comp', LANE0)} {_add(4, 'ls_red', LANE0)} "
         f"{_add(5, 'clock64() - ls_start', LANE0)}\n"
         f"  {_add(10, 'ls_dep == 0x1234567u', LANE0)} {_add(SLOTS - 1, 'ls_n', LANE0)}\n", "")), """
extern "C" int vz_probe_occupancy(int pair, int u16, int order, int* blocks, int* threads) {
  *threads = 32 * kLumaWarps;
  const void* k = u16 ? (pair ? (const void*)luma_warp_kernel<uint16_t, true, 1>
                              : (const void*)luma_warp_kernel<uint16_t, false, 1>)
                      : (pair ? (const void*)luma_warp_kernel<uint8_t, true, 1>
                              : (const void*)luma_warp_kernel<uint8_t, false, 1>);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, *threads, 0);
}
"""),
    "chroma_sse": ("xpsnr", (
        "issue a group's loads", "wait for them and sum the group's rows",
        "segmented reduction and store", "the warp's life"), (
        ("  const bool lead = ln % group == 0 && bxi < nbw;"
         "  // the lane that writes its block's sum\n", "",
         "  long long cs_issue = 0, cs_sum = 0, cs_red = 0, cs_n = 0;\n  uint32_t cs_dep = 0;\n"
         "  const long long cs_start = clock64();\n"),
        ("      LaneRow wo[kRowsAhead], wr[kRowsAhead];\n", "",
         "      const long long cs0 = clock64();\n"),
        ("#pragma unroll\n"
         "      for (int k = 0; k < kRowsAhead; ++k) acc = lane_sse<T>(wo[k], wr[k], acc);\n",
         "      const long long cs1 = clock64();\n",
         "      cs_dep ^= (uint32_t)acc;\n      const long long cs2 = clock64();\n"
         "      cs_issue += cs1 - cs0;\n      cs_sum += cs2 - cs1;\n      ++cs_n;\n"),
        ("    // the block's lanes, adjacent and a power of two, reduce among themselves\n",
         "    const long long cs3 = clock64();\n", ""),
        ("    if (lead) out[(((size_t)p * n + i) * nbh + b) * nbw + bxi] = acc;\n", "",
         "    cs_dep ^= (uint32_t)acc;\n    cs_red += clock64() - cs3;\n"),
        ("}\n\n// Blocks that fit no lane group.",
         f"  {_add(0, 'cs_issue', LANE0)} {_add(1, 'cs_sum', LANE0)} {_add(2, 'cs_red', LANE0)}\n"
         f"  {_add(3, 'clock64() - cs_start', LANE0)} {_add(10, 'cs_dep == 0x1234567u', LANE0)}\n"
         f"  {_add(SLOTS - 1, 'cs_n', LANE0)}\n", "")), """
extern "C" int vz_probe_occupancy(int a, int b, int c, int* blocks, int* threads) {
  *threads = 32 * kChromaWarps;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, chroma_strip_kernel<uint16_t, true>, *threads, 0);
}
"""),
    "compress": ("compress", (
        "issue the next frame's 8 loads", "the block's pipeline (unpack, 4 passes, pack)",
        "store", "the thread's life, per frame"), (
        ("  uint64_t rw[8];\n  load_block<kVec>(rw, x + f * plane, h, w, y0, x0);\n",
         "  long long cq_ld = 0, cq_pipe = 0, cq_st = 0, cq_n = 0;\n"
         "  const long long cq_start = clock64();\n", ""),
        ("    uint64_t nx[8];\n", "", "    const long long cq0 = clock64();\n"),
        ("    block_pipeline<kJpeg, kWide>(rw, tab, dc_prec);\n",
         "    const long long cq1 = clock64();\n", "    const long long cq2 = clock64();\n"),
        ("    if (next >= n) break;\n    f = next;\n#pragma unroll\n",
         "    const long long cq3 = clock64();\n    cq_ld += cq1 - cq0;\n"
         "    cq_pipe += cq2 - cq1;\n"
         "    cq_st += cq3 - cq2;\n    ++cq_n;\n    if (next >= n) {\n"
         f"      {_add(0, 'cq_ld', LANE0)} {_add(1, 'cq_pipe', LANE0)} {_add(2, 'cq_st', LANE0)}\n"
         f"      {_add(3, 'clock64() - cq_start', LANE0)} {_add(SLOTS - 1, 'cq_n', LANE0)}\n"
         "    }\n", "")), """
extern "C" int vz_probe_occupancy(int jpeg, int wide, int unused, int* blocks, int* threads) {
  const void* k = jpeg ? (wide ? (const void*)compress_kernel<true, true, true>
                               : (const void*)compress_kernel<true, false, true>)
                       : (wide ? (const void*)compress_kernel<false, true, true>
                               : (const void*)compress_kernel<false, false, true>);
  *threads = kThreads;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, kThreads, 0);
}
"""),
}

PROBE_READ = f"""
extern "C" int vz_probe_read(unsigned long long* out) {{
  cudaError_t e = cudaMemcpyFromSymbol(out, g_span, sizeof(g_span));
  if (e != cudaSuccess) return (int)e;
  unsigned long long zero[{SLOTS}] = {{0}};
  return (int)cudaMemcpyToSymbol(g_span, zero, sizeof(zero));
}}
"""


def instrument(kernel: str, src: str) -> str:
    """`src` with `kernel`'s spans, the counters and the probe's entry
    points; exits if an anchor is not found exactly once."""
    _, _, spans, occupancy = KERNELS[kernel]
    for anchor, before, after in spans:
        if src.count(anchor) != 1:
            raise SystemExit(f"kernel_spans: {kernel}: anchor not found once: {anchor!r}")
        src = src.replace(anchor, before + anchor + after)
    src = src.replace("namespace {\n",
                      f"__device__ unsigned long long g_span[{SLOTS}];\n\nnamespace {{\n", 1)
    return src + PROBE_READ + occupancy


def build(lib: str, text: str, name: str) -> ctypes.CDLL:
    """`text` built as library `lib` would be (its headers from the package's
    ``csrc/``); ``using`` binds the package's entry points to it."""
    src, so = OUT / f"{name}.cu", OUT / f"{name}.so"
    src.write_text(text)
    log = subprocess.run([_build._nvcc(), *_build._flags(lib), "-I", str(_build.source(lib).parent),
                          "-o", str(so), str(src)], capture_output=True, text=True)
    if log.returncode != 0:
        raise SystemExit(f"kernel_spans: build of {name} failed:\n{log.stdout}{log.stderr}")
    out = ctypes.CDLL(str(so))
    if hasattr(out, "vz_probe_read"):
        out.vz_probe_read.argtypes = [ctypes.c_void_p]
    return out


def registers(lib: str, kernel: str) -> str:
    """ptxas' 'Used ...' and stack frame lines of each instantiation of
    `kernel` in the package's build."""
    out, fn, frame = [], None, ""
    for line in _build.library_path(lib).with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn, frame = m.group(1), ""
        elif "stack frame" in line:
            frame = line.split(":", 1)[-1].strip()
        elif "Used" in line and fn and kernel in fn:
            out.append(f"{fn.split(kernel, 1)[1][:16]}: {line.split(':', 1)[-1].strip()}, {frame}")
    return "; ".join(out)


def using(lib: str, copy: ctypes.CDLL, call):
    """`call()` with library `lib`'s entry points bound to `copy`."""
    _build.bind(lib, copy)
    try:
        return call()
    finally:
        _build.bind(lib)


def events_ms(call, iters: int = 5) -> float:
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        call()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def device_ms(call, iters: int = 5, name: str = "") -> float:
    """Mean device time of the kernels one `call` launches (``torch.profiler``):
    unlike events around back-to-back calls, it leaves out the host's time
    between launches, which a call of a few microseconds of device work
    cannot hide.  With `name`, the mean of one launch of the kernels whose
    name holds it (a call that launches one such kernel): a trace that lost
    some of their events (the profiler does, PERF.md section 7) still gives
    their mean."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    us = [ev.time_range.end - ev.time_range.start for ev in prof.events()
          if ev.device_type == torch.autograd.DeviceType.CUDA and name in ev.name]
    if not us:
        raise SystemExit("kernel_spans: the profiler saw no device activity")
    return sum(us) / 1e3 / (len(us) if name else iters)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """`t` as integers holding its bit pattern: floats by their IEEE bits (so
    -0.0 is not +0.0, and a NaN equals itself), integers widened."""
    if t.is_floating_point():
        return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])
    return t.to(torch.int64)


def _same(a, b) -> bool:
    """Equal dtypes, shapes and bit patterns, as chip_smoke.py compares."""
    a, b = (a if isinstance(a, tuple) else (a,)), (b if isinstance(b, tuple) else (b,))
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(_bits(x), _bits(y))
        for x, y in zip(a, b))


def measure(kernel: str, probe: ctypes.CDLL, label: str, call, occ=None, timer=events_ms) -> None:
    """Time `call` on the package's build (`timer`: events by default), run it
    once on `probe`, hold the outputs equal and print the spans."""
    lib, names = KERNELS[kernel][:2]
    ms = timer(call)
    want = call()
    buf = (ctypes.c_ulonglong * SLOTS)()
    probe.vz_probe_read(buf)
    got = using(lib, probe, call)
    torch.cuda.synchronize()
    probe.vz_probe_read(buf)
    if not _same(got, want):
        raise SystemExit(f"kernel_spans: {label}: the instrumented kernel disagrees")
    n = max(buf[SLOTS - 1], 1)
    spans = ", ".join(f"{nm} {buf[i] / n:,.1f}" for i, nm in enumerate(names))
    line = f"{label}: {ms:.3f} ms; {n} spans; mean cycles: {spans}"
    if occ is not None:
        blocks, threads = ctypes.c_int(), ctypes.c_int()
        probe.vz_probe_occupancy.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
        err = probe.vz_probe_occupancy(*occ, ctypes.byref(blocks), ctypes.byref(threads))
        if err:
            raise SystemExit(f"kernel_spans: occupancy query failed ({err})")
        line += f"; {blocks.value} blocks of {threads.value} threads resident per SM"
    print(line, flush=True)


def eedi3_line(probe, g, dev) -> None:
    rows = [_pad_rows(torch.rand((FRAMES, 540, W), generator=g, device=dev)).contiguous()
            for _ in range(4)]
    mask = torch.rand((FRAMES, 540, W), generator=g, device=dev) > 0.3
    for label, variant, call in (
            ("B8", 0, lambda: ke.eedi3_fused(*rows, W, MDIS, NRAD, *EEDI3_COEFS, None)),
            ("B8 with mclip", 1, lambda: ke.eedi3_fused(*rows, W, MDIS, NRAD, *EEDI3_COEFS, mask)),
            ("B9 (hp)", 2, lambda: ke.eedi3_fused_hp(*rows, W, MDIS, NRAD, *EEDI3_COEFS))):
        measure("eedi3_line", probe, label, call, (W, MDIS, variant))


def vcheck(probe, g, dev) -> None:
    src = _build.source("eedi3").read_text()
    one = src.replace("constexpr int kVcheckCluster = 8;", "constexpr int kVcheckCluster = 1;")
    if one == src:
        raise SystemExit("kernel_spans: kVcheckCluster not found")
    single = build("eedi3", one, "vcheck_single")
    for hp in (False, True):
        dr = 2 * MDIS if hp else MDIS
        vin = (torch.rand((LINES, FRAMES, W), generator=g, device=dev),
               torch.rand((LINES, 3, FRAMES, W), generator=g, device=dev),
               torch.randint(-dr, dr + 1, (LINES, 3, FRAMES, W), generator=g, device=dev,
                             dtype=torch.int32),
               torch.rand((LINES, FRAMES, W), generator=g, device=dev),
               torch.rand((FRAMES, W), generator=g, device=dev))

        def call():
            return ke.vcheck(*vin, W, MDIS, hp, 2, *RCP)
        measure("vcheck", probe, f"B10 <{int(hp)}> (per line of thread 0)", call)
        if not torch.equal(using("eedi3", single, call), call()):
            raise SystemExit("kernel_spans: B10 on one block per frame disagrees")
        print(f"B10 <{int(hp)}> on one block per frame (the same ring and values ahead, no "
              f"halo): {events_ms(lambda: using("eedi3", single, call)):.3f} ms", flush=True)


def _bd_consts():
    """BilateralDither's defaults on a 16-bit plane (thr 2.5, flat 0.4): m,
    wmax, swmin and peak as the op rounds them."""
    return (float(np.float32(2.5 * 256)), float(np.float32(np.float32(2.5) * np.float32(0.6)
                                                          * np.float32(256))), 1.0, 65535.0)


def subspl(probe, g, dev) -> None:
    obd = importlib.import_module("vszip_tpu_torch.ops.bilateral_dither")
    dyx, k = obd._table(16, 0.0, str(dev))
    for h, w in ((1080, 1920), (540, 960)):
        x = torch.randint(0, 1 << 16, (64, h, w), generator=g, device=dev,
                          dtype=torch.int32).to(torch.uint16)
        start = obd._start_rows(h, str(dev))
        frames, cols, rows = kbd._subspl_band(x, None, 16, k)
        label = f"B18 r 16, k {k}, 64x{h}x{w} u16"

        def call():
            return kbd.subspl_blur(x, None, 16, start, dyx, *_bd_consts())
        measure("subspl", probe, f"{label}, bands of {frames} frame(s) x {cols} columns x {rows} "
                "rows (thread 0, per block and frame group)", call)


def int8_picture(n, h, w, g, dev):
    """A smooth pattern that moves a little each frame, noise of +-3 and a
    band of combed rows (chip_smoke.py's 8-bit picture)."""
    y = torch.arange(h, device=dev).view(1, h, 1).float()
    x = torch.arange(w, device=dev).view(1, 1, w).float()
    f = torch.arange(n, device=dev).view(n, 1, 1).float()
    v = 128 + 60 * torch.sin(x / 37 + f / 5) * torch.cos(y / 23 - f / 11)
    v = v + torch.randint(-3, 4, (n, h, w), generator=g, device=dev)
    v[:, h // 3:2 * h // 3:2] += 40
    return v.clamp(0, 255).to(torch.uint8)


def checkmate(probe, g, dev) -> None:
    for h, w in ((1080, 1920), (540, 960)):
        x = int8_picture(64, h, w, g, dev)
        for tthr2 in (0, 10):
            label = f"B15 tthr2 {tthr2}, 64x{h}x{w} u8"

            def call():
                return kk.checkmate(x, 12, 12, tthr2)
            measure("checkmate", probe, f"{label} (thread 0, per frame)", call,
                    (int(tthr2 > 0), 1, 0))


def v_fixed(probe, g, dev) -> None:
    x = torch.randint(0, 1 << 16, (64, 1080, 1920), generator=g, device=dev,
                      dtype=torch.int32).to(torch.uint16)
    for r, passes in ((13, 5), (23, 1)):
        def call():
            return kb.rt_blur_v_multi(x, r, passes) if passes > 1 else kb.rt_blur_v(x, r)
        measure("v_fixed", probe, f"v_fixed r {r}, {passes} pass(es), 64x1080x1920 u16 "
                "(lane 0 of each warp, per step)", call, (r, passes, 0))


def ct_v_quant(probe, g, dev) -> None:
    for h, w in ((1080, 1920), (540, 960)):
        x = torch.randint(0, 1 << 16, (64, h, w), generator=g, device=dev,
                          dtype=torch.int32).to(torch.uint16)
        measure("ct_v_quant", probe, f"ct_v_chip r 13, 64x{h}x{w} u16 (lane 0 of each warp, "
                "per step)", lambda: kb._ct_v(x, 13), (13, 0, 0))


def ct_blur(probe, g, dev) -> None:
    for h, w in ((1080, 1920), (540, 960)):
        x = torch.randint(0, 1 << 16, (64, h, w), generator=g, device=dev,
                          dtype=torch.int32).to(torch.uint16)
        measure("ct_blur", probe, f"ct_blur r 13, 64x{h}x{w} u16 (thread 0 of each block, "
                "per group)", lambda: kb.ct_blur_int(x, 13))


def recorded(module, name: str, run) -> list:
    """The arguments of every call of ``module.name`` that ``run()`` makes."""
    calls, fn = [], getattr(module, name)
    setattr(module, name, lambda *a: calls.append(a) or fn(*a))
    try:
        run()
    finally:
        setattr(module, name, fn)
    return calls


def m2_calls(g, dev):
    """The arguments of the 3 B6 launches of ``deband(c)`` on 64 frames of
    1080p YUV420P16 (chip_smoke.py's ``deband_m2`` row), one per plane."""
    import vszip_tpu_torch as vt

    planes = [torch.randint(0, 1 << 16, (64, h, w), generator=g, device=dev,
                            dtype=torch.int32).to(torch.uint16)
              for h, w in ((1080, 1920), (540, 960), (540, 960))]
    clip = vt.Clip.from_planes(planes, vt.get_format("YUV420P16"), device=dev)
    return recorded(kd, "deband_m2_center", lambda: vt.deband(clip))


def m2(probe, g, dev) -> None:
    # a copy whose taps all read the centre: no bank conflicts (its outputs
    # differ and are not compared), to time what the random taps cost
    src = _build.source("deband").read_text()
    taps = "          const int o1 = (int)(p << 16) >> 16, o2 = (int)p >> 16;\n"
    if src.count(taps) != 1:
        raise SystemExit("kernel_spans: m2_tile's tap offsets not found")
    centre = build("deband", src.replace(taps, "          const int o1 = 0, o2 = 0;\n"),
                   "m2_centre")
    for x, key, bf, rmax, thr in m2_calls(g, dev):
        n, h, w = x.shape

        def call():
            return kd.deband_m2_center(x, key, bf, rmax, thr)
        measure("m2", probe, f"B6 m2_tile deband() plane {n}x{h}x{w}, rmax {rmax}, blur_first "
                f"{bf} (lane 0 of each warp, per pair of frames)", call, (rmax, 0, 0))
        print(f"B6 with every tap at the centre (no bank conflicts): "
              f"{events_ms(lambda: using("deband", centre, call)):.3f} ms", flush=True)


def comb_mask(probe, g, dev) -> None:
    for h, w in ((1080, 1920), (540, 960)):
        x = int8_picture(64, h, w, g, dev)
        measure("comb_mask", probe, f"B16 metric 0, cthresh 6, mthresh 9, expand, 64x{h}x{w} "
                "u8 (lane 0 of each warp, per frame)",
                lambda: km.comb_mask(x, 6, 9, False, True), (0, 1, 1))


def ssim_clips(g, dev):
    """The two clips of chip_smoke.py's SSIMULACRA2 row: 8 frames of 1080p
    RGBS, r2 = r1 + 0.01, clamped."""
    import vszip_tpu_torch as vt

    r1 = [torch.rand((8, 1080, 1920), generator=g, device=dev) for _ in range(3)]
    r2 = [(p + 0.01).clamp(0, 1) for p in r1]
    return tuple(vt.Clip.from_planes(p, vt.get_format("RGBS"), device=dev) for p in (r1, r2))


def ssim_calls(c1, c2):
    """The arguments of the 11 B13 launches of one ``ssimulacra2(c1, c2)``
    call, each with its (scale, plane)."""
    import vszip_tpu_torch as vt

    oss = importlib.import_module("vszip_tpu_torch.ops.ssimulacra2")
    calls = recorded(kss, "ssim_sums", lambda: vt.ssimulacra2(c1, c2))
    kept = [(scale, plane) for scale in range(6) for plane in range(3)
            if not all(oss._skip(plane, scale).values())]
    return [(sp, a) for sp, a in zip(kept, calls) if min(a[0].shape[1:]) >= oss.MIN_KERNEL_SIDE]


def forcing(cols):
    """``kss.ssim_partials`` with its variant forced to `cols` (None: the
    launcher's choice), for a ``using``-style patch."""
    fn = kss.ssim_partials
    return fn if cols is None else (lambda im1, im2, ns, ne: fn(im1, im2, ns, ne, cols))


def ssim(probe, g, dev) -> None:
    import vszip_tpu_torch as vt

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    c1, c2 = ssim_clips(g, dev)
    total = {}
    for (scale, plane), (im1, im2, ns, ne) in ssim_calls(c1, c2):
        n, h, w = im1.shape

        def call():
            return kss.ssim_partials(im1, im2, ns, ne)
        total[scale] = total.get(scale, 0.0) + device_ms(call)
        cols = kss.lane_columns(n, h, w, sms)
        measure("ssim", probe, f"B13 scale {scale} plane {plane}, {n}x{h}x{w}, ssim {int(ns)} "
                f"err {int(ne)}, {cols} column(s) a lane; device ms with "
                + ", ".join(f"{c}: {device_ms(lambda: forcing(c)(im1, im2, ns, ne)):.4f}"
                            for c in (2, 1))
                + " (lane 0 of each warp, per warp)", call, (int(ns), int(ne), cols))
    print("B13 device ms by scale (each launch's kernel time, summed): "
          + ", ".join(f"scale {k} {v:.4f}" for k, v in total.items())
          + f"; all {sum(total.values()):.4f}", flush=True)
    # the whole row's device time (every kernel of ssimulacra2) with the
    # launcher's choice and with each variant forced, in turns
    row = {None: [], 2: [], 1: []}
    for cols in (None, 2, 1, 1, 2, None):
        fn, kss.ssim_partials = kss.ssim_partials, forcing(cols)
        try:
            row[cols].append(device_ms(lambda: vt.ssimulacra2(c1, c2)))
        finally:
            kss.ssim_partials = fn
    print("ssimulacra2 row device ms (8 x 1080p RGBS): " + ", ".join(
        f"{'choice' if c is None else f'{c} columns'} {sum(t) / 2:.4f} ({t[0]:.4f}, {t[1]:.4f})"
        for c, t in row.items()), flush=True)
    # the choice's threshold: both variants across the grid sizes around it,
    # 270x480 planes (scale 2's) of n frames
    for n in (2, 4, 8, 12, 16, 20, 24, 28, 32):
        im1 = torch.rand((n, 270, 480), generator=g, device=dev)
        im2 = (im1 + 0.01).clamp(0, 1)
        print(f"B13 {n}x270x480 on {sms} SMs, the launcher takes "
              f"{kss.lane_columns(n, 270, 480, sms)}; device ms with " + ", ".join(
                  f"{c}: {device_ms(lambda: forcing(c)(im1, im2, True, True)):.4f}"
                  for c in (2, 1)), flush=True)


def bank_wavefronts(keys: torch.Tensor) -> torch.Tensor:
    """Shared-memory wavefronts of warp-loads of 4-byte words at the word
    indices `keys` (..., 32), a lane that takes no part holding the index of
    one that does: the most distinct words that any one bank holds."""
    k, _ = keys.sort(-1)
    first = torch.ones_like(k, dtype=torch.int32)
    first[..., 1:] = (k[..., 1:] != k[..., :-1]).to(torch.int32)
    cnt = torch.zeros(k.shape[:-1] + (32,), dtype=torch.int32, device=k.device)
    cnt.scatter_add_(-1, k & 31, first)
    return cnt.amax(-1)


def clahe_lanes(w: int, layout):
    """The (row within a band, column) of each lane of each table warp-load
    of one band of rows, each (loads, 32), -1 where a lane takes no part,
    and the band's rows, for ``clahe8_chunk_kernel``'s `layout` (bx, by,
    chunk): bx threads a row of `by` rows, each on `chunk` consecutive
    bytes, warp-load j reading byte j of every lane's chunk."""
    bx, by, chunk = layout
    tid = torch.arange(-(-bx * by // 32) * 32)
    tx, ty = tid % bx, tid // bx
    rows, cols = [], []
    for j in range(chunk):
        c = chunk * tx + j
        on = (tid < bx * by) & (c < w)
        rows.append(torch.where(on, ty, -1).view(-1, 32))
        cols.append(torch.where(on, c, -1).view(-1, 32))
    return torch.cat(rows), torch.cat(cols), by


def clahe_wavefronts(x, tab32, tile_h, tile_w, layout) -> float:
    """Mean wavefronts of one warp's table load on B7's inputs (the data's
    bytes choose the banks) for the lanes' `layout` (``clahe_lanes``)."""
    n, h, w = x.shape
    rx_n = tab32.shape[2] // 256
    rows, cols, band = clahe_lanes(w, layout)
    rows, cols = rows.to(x.device), cols.to(x.device)
    keep = (cols >= 0).any(1)
    rows, cols = rows[keep], cols[keep]
    lead = (cols >= 0).int().argmax(1, keepdim=True)  # an active lane of each load
    rows = torch.where(cols >= 0, rows, rows.gather(1, lead))
    cols = torch.where(cols >= 0, cols, cols.gather(1, lead))
    starts = torch.arange(0, h - band + 1, band, device=x.device).view(-1, 1, 1)
    y = starts + rows  # (bands, loads, 32)
    cell = ((y + tile_h // 2) // tile_h) * rx_n + (cols + tile_w // 2) // tile_w
    total = count = 0
    for f in range(n):
        keys = cell * 256 + x[f].to(torch.int64)[y, cols]
        wf = bank_wavefronts(keys)
        total += float(wf.sum())
        count += wf.numel()
    return total / count


def clahe8_call(g, dev):
    """The arguments of the B7 launch of ``clahe(c)`` on 64 frames of 1080p
    GRAY8 noise (chip_smoke.py's ``clahe_8bit`` row)."""
    import vszip_tpu_torch as vt

    x = torch.randint(0, 256, (64, 1080, 1920), generator=g, device=dev,
                      dtype=torch.int32).to(torch.uint8)
    clip = vt.Clip.from_planes([x], vt.get_format("GRAY8"), device=dev)
    (a,) = recorded(kc, "clahe8_lookup", lambda: vt.clahe(clip))
    return a


def clahe8(probe, g, dev) -> None:
    a = clahe8_call(g, dev)
    layout = (*kc.block_shape(1920), kc.CHUNK)
    wf = clahe_wavefronts(a[0], a[1], a[4], a[5], layout)
    measure("clahe8", probe, f"B7 clahe(c) 64x1080x1920 u8, tiles {a[4]}x{a[5]}, table "
            f"{tuple(a[1].shape)}, blocks of {layout[0]}x{layout[1]} threads; {wf:.3f} "
            "wavefronts a warp's table load (the data's banks; thread 0, per row of its "
            "chunk)", lambda: kc.clahe8_lookup(*a), (layout[0] * layout[1], 1, 16))


def xpsnr_pair(g, dev, shape=(32, 1080, 1920)):
    """A plane of chip_smoke.py's XPSNR row (its luma by default): 32 frames
    of 1080p 10-bit noise and the same plus noise in [-8, 8), clamped."""
    org = torch.randint(0, 1024, shape, generator=g, device=dev, dtype=torch.int32)
    rec = (org + torch.randint(-8, 8, org.shape, generator=g, device=dev,
                               dtype=torch.int32)).clamp(0, 1023)
    return org.to(torch.uint16), rec.to(torch.uint16)


def luma_stats(probe, g, dev) -> None:
    org, rec = xpsnr_pair(g, dev)
    for order, temporal in ((1, True), (2, True), (1, False)):
        measure("luma_stats", probe, f"B11 32x1080x1920 u16, order {order}, temporal "
                f"{int(temporal)} (lane 0 of each warp, per row step)",
                lambda: kx.luma_stats(org, rec, order, temporal), (1, 1, 0))


def xpsnr_chroma(g, dev):
    """The chroma planes of chip_smoke.py's XPSNR row: U and V of 32 frames
    of 1080p YUV420P10 noise (540x960), org and rec as ``xpsnr_pair``'s."""
    org, rec = zip(*(xpsnr_pair(g, dev, (32, 540, 960)) for _ in range(2)))
    return org, rec


def chroma_sse(probe, g, dev) -> None:
    (ou, ov), (ru, rv) = xpsnr_chroma(g, dev)
    for label, call in (("both chroma planes (the row's launch)",
                         lambda: kx.chroma_sse_uv(ou, ru, ov, rv, 32, 32)),
                        ("one chroma plane", lambda: kx.chroma_sse(ou, ru, 32, 32))):
        measure("chroma_sse", probe, f"B12 {label}, 32x540x960 u16, 32x32 blocks, the "
                "kernel's device time (lane 0 of each warp, per group of rows)", call, (0, 0, 0),
                lambda c: device_ms(c, name="chroma_"))


def dc_only_shares(a):
    """(rows, warps): the share of the 8-point IDCT rows whose coefficients
    1-7 are all zero, and of warps whose 32 blocks (adjacent in a frame's
    block order, a thread per block) all take that path in row r together,
    skipping the full row IDCT."""
    q = kz.dequantized(*a)
    dc = (q[..., 1:] == 0).all(-1)  # (N, H/8, 8 rows, W/8 blocks)
    dc = dc.permute(0, 2, 1, 3).reshape(dc.shape[0], 8, -1)
    pad = -dc.shape[-1] % 32
    grouped = torch.nn.functional.pad(dc, (0, pad), value=True).view(*dc.shape[:-1], -1, 32)
    return float(dc.float().mean()), float(grouped.all(-1).float().mean())


def compress(probe, g, dev) -> None:
    oz = importlib.import_module("vszip_tpu_torch.ops.compress")
    for h, w in ((1080, 1920), (540, 960)):
        x = int8_picture(64, h, w, g, dev)
        for codec, quality, name in (("mpeg2", 50, "MPEG-2 q8"), ("jpeg", 95, "JPEG q95")):
            qa, qb, wide, _ = oz._quant_setup(codec, 8, 0, quality, h < 1080)
            a = (x, qa, qb, codec == "jpeg", 0, wide)
            rows, warps = dc_only_shares(a)
            measure("compress", probe, f"B14 {name} (wide {int(wide)}), 64x{h}x{w} u8; DC-only "
                    f"rows {rows:.4f}, warps {warps:.4f} (lane 0 of each warp, per frame)",
                    lambda: kz.compress_plane(*a), (int(codec == "jpeg"), int(wide), 0))


RUNS = {"eedi3_line": eedi3_line, "vcheck": vcheck, "subspl": subspl,
        "checkmate": checkmate, "v_fixed": v_fixed, "ct_v_quant": ct_v_quant,
        "ct_blur": ct_blur, "m2": m2,
        "comb_mask": comb_mask, "ssim": ssim, "compress": compress, "clahe8": clahe8,
        "luma_stats": luma_stats, "chroma_sse": chroma_sse}
# the instantiations the bench's calls launch (B18: uint16, no ref)
SASS_OF = {"subspl": "subspl_kernelItLb0E", "checkmate": "checkmate_kernel",
           "v_fixed": "v_chip_kernelItLi[15]ELb1E", "comb_mask": "comb_mask_kernelILb0ELb1ELb1E",
           "ssim": "ssim_band_kernelILb1ELb1ELi[12]E",
           "compress": "compress_kernelILb(0ELb0|1ELb1)ELb1E",
           "ct_v_quant": "ct_v_chip_kernelItLb1E", "ct_blur": "ct_blur_kernelItLi28EE",
           "m2": "m2_tile_kernelILb1ELb1E",
           "clahe8": "clahe8_chunk_kernelILb1ELi16E", "luma_stats": "luma_warp_kernelItLb1ELi1E",
           "chroma_sse": "chroma_strip_kernelItLb1EE"}
# the kernel function of a table whose name is not <table>_kernel
FUNCTION = {"v_fixed": "v_chip_kernel", "ssim": "ssim_band_kernel",
            "ct_v_quant": "ct_v_chip_kernel", "m2": "m2_tile_kernel",
            "clahe8": "clahe8_chunk_kernel", "luma_stats": "luma_warp_kernel",
            "chroma_sse": "chroma_strip_kernel"}
SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)[^;]*;")


# SASS opcodes by class: f32 arithmetic, integer and address arithmetic,
# loads, stores; the rest (moves, branches, barriers, ...) is "other"
CLASSES = (("f32", re.compile(r"F(ADD|MUL|FMA|MNMX|SETP|SEL|CHK|RND)|MUFU")),
           ("int", re.compile(r"I(MAD|MUL|ADD3?|MNMX|ABS|SETP)|VIADD|VIMNMX|VIADDMNMX|LEA|SHF"
                              r"|LOP3|SEL|PRMT|IDP|POPC|FLO|BMSK|SGXT")),
           ("load", re.compile(r"LD[A-Z]*")), ("store", re.compile(r"ST[GSL]?")))


def _mix(ops) -> str:
    counts = {}
    for op in ops:
        counts[op] = counts.get(op, 0) + 1
    by_class = {}
    for op, n in counts.items():
        c = next((name for name, pat in CLASSES if pat.fullmatch(op)), "other")
        by_class[c] = by_class.get(c, 0) + n
    classes = ", ".join(f"{c} {by_class.get(c, 0)}"
                        for c in ("f32", "int", "load", "store", "other"))
    return (f"[{classes}] "
            + ", ".join(f"{op} {n}" for op, n in sorted(counts.items(), key=lambda kv: -kv[1])))


def sass(lib: str, kernel: str) -> None:
    """The instruction mix of each instantiation whose mangled name holds
    `kernel` in the package's build (``cuobjdump -sass``): the whole function, and each loop
    (a backward branch) of at least 8 instructions, innermost first."""
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(_build.library_path(lib))],
                          capture_output=True, text=True, check=True).stdout
    for block in text.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        if not re.search(kernel, name):
            continue
        code, labels, addr = [], {}, None
        for line in block.splitlines():
            m = re.match(r"\s*(\.L_x_\d+):", line)
            if m:
                labels[m.group(1)] = None if addr is None else addr + 16
                continue
            m = SASS_LINE.search(line)
            if m:
                addr = int(m.group(1), 16)
                code.append((addr, m.group(2), line))
                for lab, at in labels.items():
                    if at is None:
                        labels[lab] = addr
        print(f"SASS {name[:90]}: {len(code)} instructions: {_mix(op for _, op, _ in code)}")
        loops = []
        for at, op, line in code:
            if op != "BRA":
                continue
            t = re.search(r"\(?(\.L_x_\d+)\)?", line)
            h = re.search(r"BRA\s+(?:\S+\s+)?0x([0-9a-f]+)", line)
            target = labels.get(t.group(1)) if t else int(h.group(1), 16) if h else None
            if target is not None and target <= at:
                loops.append((target, at))
        for lo, hi in sorted(loops, key=lambda l: l[1] - l[0]):
            body = [op for a, op, _ in code if lo <= a <= hi]
            if len(body) >= 8:
                print(f"  loop {lo:#06x}-{hi:#06x}: {len(body)} instructions: {_mix(body)}")


def main() -> int:
    chosen = sys.argv[1:] or list(KERNELS)
    if any(k not in KERNELS for k in chosen):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_spans: no CUDA device", file=sys.stderr)
        return 1
    OUT.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {smi.strip()}")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    _build.build(*{KERNELS[k][0] for k in chosen})
    for kernel in chosen:
        lib = KERNELS[kernel][0]
        probe = build(lib, instrument(kernel, _build.source(lib).read_text()),
                      f"{kernel}_probe")
        print(f"{kernel} registers:", registers(lib, FUNCTION.get(kernel, f"{kernel}_kernel")),
              flush=True)
        if kernel in SASS_OF:
            sass(lib, SASS_OF[kernel])
        RUNS[kernel](probe, g, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
