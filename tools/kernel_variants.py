#!/usr/bin/env python3
"""Times build copies of the port's CUDA sources with other constants against
the package's own build, on one NVIDIA GPU:

    python3 tools/kernel_variants.py          # every variant below
    python3 tools/kernel_variants.py B1 B6    # those of some kernels

Each variant replaces one constant line of a source in
``vszip_tpu_torch/csrc/``, builds the copy with the package's nvcc flags into
``build/kernel_spans/``, holds its outputs equal to the package's build, and
times the package and the copy in turns (package, copy, copy, package; CUDA
events, 10 calls each) at the bench's shapes: BoxBlur's vertical passes
(B3 at r 13 x 5, B4 at r 23, B1's vertical stage at r 13) on 64 frames of
1080p YUV420P16, Deband mode 2's centre (B6) on the three planes of
``deband(c)`` on such a clip, CombMask (B16)
at its defaults on 64 frames of 1080p YUV420P8 of ``chip_smoke.py``'s
8-bit picture, SSIMULACRA2's B13 on the 11 launches of its 1080p row (by
device time, ``torch.profiler``: the small scales' launches take less
device time than the host takes to issue them), CLAHE's B7 on the launch of
``clahe(c)`` on 64 frames of 1080p GRAY8 noise, XPSNR's B11 on the luma of
32 frames of 1080p 10-bit noise (order 1, as at 24 fps) and B12 on both
chroma planes of that clip (32x32 blocks, one launch; the kernel's device
time, ``torch.profiler``).  A variant may also
set attributes of the wrapper's module for its calls (B12's lane width,
which the wrapper's ``strip_group`` and ``wide_loads`` read).  It prints
each variant's mean beside the package's.
"""

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import kernel_spans as ks  # noqa: E402
from vszip_tpu_torch import _build  # noqa: E402
from vszip_tpu_torch.kernels import boxblur as kb  # noqa: E402
from vszip_tpu_torch.kernels import clahe as kc  # noqa: E402
from vszip_tpu_torch.kernels import comb_mask as km  # noqa: E402
from vszip_tpu_torch.kernels import deband as kd  # noqa: E402
from vszip_tpu_torch.kernels import ssim as kss  # noqa: E402
from vszip_tpu_torch.kernels import xpsnr as kx  # noqa: E402

# (library, the constant's line in the package's source, its replacement,
# the calls it is timed on[, the wrapper module's attributes for the copy])
VARIANTS = [
    ("comb_mask", "constexpr int kBand = 8; ", "constexpr int kBand = 4; ", "B16"),
    ("comb_mask", "constexpr int kBand = 8; ", "constexpr int kBand = 12;", "B16"),
    ("comb_mask", "constexpr int kBand = 8; ", "constexpr int kBand = 16;", "B16"),
    ("comb_mask", "constexpr int kRun = 4;", "constexpr int kRun = 8;", "B16"),
    ("comb_mask", "constexpr int kRun = 4;", "constexpr int kRun = 16;", "B16"),
    ("comb_mask", "constexpr int kWarps = 4;", "constexpr int kWarps = 8;", "B16"),
    ("boxblur", "constexpr int kAheadGroups = 4;", "constexpr int kAheadGroups = 2;", "B3"),
    ("boxblur", "constexpr int kAheadGroups = 4;", "constexpr int kAheadGroups = 8;", "B3"),
    ("boxblur", "constexpr int kAheadGroups = 4;", "constexpr int kAheadGroups = 2;", "B4"),
    ("boxblur", "constexpr int kAheadGroups = 4;", "constexpr int kAheadGroups = 8;", "B4"),
    # B1's vertical stage (ct_v_chip): copies 32 rows ahead (v_chip's too)
    ("boxblur", "constexpr int kAheadGroups = 4;", "constexpr int kAheadGroups = 8;", "B1"),
    # B6 (m2_tile): tiles of 32 rows (2 rows of 4 pixels a thread); 2 or 8
    # pairs of frames an item; 2 or 4 blocks an SM
    ("deband", "constexpr int kM2TileY = 64;", "constexpr int kM2TileY = 32;", "B6"),
    ("deband", "constexpr int kM2Group = 4;", "constexpr int kM2Group = 2;", "B6"),
    ("deband", "constexpr int kM2Group = 4;", "constexpr int kM2Group = 8;", "B6"),
    ("deband", "__launch_bounds__(kM2Threads, 3)", "__launch_bounds__(kM2Threads, 2)", "B6"),
    ("deband", "__launch_bounds__(kM2Threads, 3)", "__launch_bounds__(kM2Threads, 4)", "B6"),
    # B13's blocks an SM at 2 columns a lane: 2 (128 registers) or 4 (64)
    ("ssim", "__launch_bounds__(kMaxThreads, kCols == 2 ? 3 : 4)",
     "__launch_bounds__(kMaxThreads, kCols == 2 ? 2 : 4)", "B13"),
    ("ssim", "__launch_bounds__(kMaxThreads, kCols == 2 ? 3 : 4)",
     "__launch_bounds__(kMaxThreads, kCols == 2 ? 4 : 4)", "B13"),
    # B7: one block of 480 an SM (no register cap: 80 registers)
    ("clahe", "__launch_bounds__(kMaxThreads, 2)\n", "__launch_bounds__(kMaxThreads)\n", "B7"),
    # B11: 2 or 4 blocks a warp down a column strip (fewer halo rows, fewer
    # warps); 2 or 8 warps a thread block; loads 1 or 3 steps ahead
    ("xpsnr", "constexpr int kBlocksPerWarp = 1;", "constexpr int kBlocksPerWarp = 2;", "B11"),
    ("xpsnr", "constexpr int kBlocksPerWarp = 1;", "constexpr int kBlocksPerWarp = 4;", "B11"),
    ("xpsnr", "constexpr int kLumaWarps = 4;", "constexpr int kLumaWarps = 2;", "B11"),
    ("xpsnr", "constexpr int kLumaWarps = 4;", "constexpr int kLumaWarps = 8;", "B11"),
    ("xpsnr", "constexpr int kAhead = 2;", "constexpr int kAhead = 1;", "B11"),
    ("xpsnr", "constexpr int kAhead = 2;", "constexpr int kAhead = 3;", "B11"),
    # B11's row loop unrolled 3 times (the window's rows renamed, not moved)
    ("xpsnr", "    for (int y = b * kLumaBlock; y < ye; ++y) {",
     "#pragma unroll 3\n    for (int y = b * kLumaBlock; y < ye; ++y) {", "B11"),
    # B12: 2 or 8 uint16 columns a lane (4- or 16-byte loads; strips of 64 or
    # 256 columns); 2 or 4 block rows a warp; 4 or 16 rows' loads issued
    # together; 2 or 8 warps a block
    ("xpsnr", "constexpr int kLaneBytes = 8; ", "constexpr int kLaneBytes = 4; ", "B12",
     {"LANE_BYTES": 4}),
    ("xpsnr", "constexpr int kLaneBytes = 8; ", "constexpr int kLaneBytes = 16;", "B12",
     {"LANE_BYTES": 16}),
    ("xpsnr", "constexpr int kStripRows = 1;", "constexpr int kStripRows = 2;", "B12"),
    ("xpsnr", "constexpr int kStripRows = 1;", "constexpr int kStripRows = 4;", "B12"),
    ("xpsnr", "constexpr int kRowsAhead = 8;", "constexpr int kRowsAhead = 4;", "B12"),
    ("xpsnr", "constexpr int kRowsAhead = 8;", "constexpr int kRowsAhead = 16;", "B12"),
    ("xpsnr", "constexpr int kChromaWarps = 4;", "constexpr int kChromaWarps = 2;", "B12"),
    ("xpsnr", "constexpr int kChromaWarps = 4;", "constexpr int kChromaWarps = 8;", "B12"),
    # B12's lane loads as streaming (evict-first) loads; 12 or 16 blocks an
    # SM (40 or 32 registers)
    ("xpsnr", "*reinterpret_cast<Vec*>(r.v) = __ldg(", "*reinterpret_cast<Vec*>(r.v) = __ldcs(",
     "B12"),
    ("xpsnr", "__launch_bounds__(32 * kChromaWarps)\n    chroma_strip_kernel(",
     "__launch_bounds__(32 * kChromaWarps, 12)\n    chroma_strip_kernel(", "B12"),
    ("xpsnr", "__launch_bounds__(32 * kChromaWarps)\n    chroma_strip_kernel(",
     "__launch_bounds__(32 * kChromaWarps, 16)\n    chroma_strip_kernel(", "B12"),
]


def with_attrs(module, attrs, call):
    """`call()` with `module`'s attributes set to `attrs` for the duration."""
    saved = {k: getattr(module, k) for k in attrs}
    try:
        for k, v in attrs.items():
            setattr(module, k, v)
        return call()
    finally:
        for k, v in saved.items():
            setattr(module, k, v)


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    chosen = [v for v in VARIANTS if not sys.argv[1:] or v[3] in sys.argv[1:]]
    ks.OUT.mkdir(parents=True, exist_ok=True)
    _build.build(*{v[0] for v in chosen})
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    p16 = [torch.randint(0, 1 << 16, s, generator=g, device=dev, dtype=torch.int32)
           .to(torch.uint16) for s in ((64, 1080, 1920), (64, 540, 960), (64, 540, 960))]
    p8 = [ks.int8_picture(64, h, w, g, dev) for h, w in ((1080, 1920), (540, 960), (540, 960))]
    b13 = [a for _, a in ks.ssim_calls(*ks.ssim_clips(g, dev))] if any(v[3] == "B13" for v in chosen) else []
    b6 = ks.m2_calls(g, dev) if any(v[3] == "B6" for v in chosen) else []
    b7 = ks.clahe8_call(g, dev) if any(v[3] == "B7" for v in chosen) else ()
    b11 = ks.xpsnr_pair(g, dev) if any(v[3] == "B11" for v in chosen) else ()
    b12 = ks.xpsnr_chroma(g, dev) if any(v[3] == "B12" for v in chosen) else ((), ())
    calls = {"B16": (km, lambda: [km.comb_mask(p, 6, 9, False, True) for p in p8]),
             "B1": (kb, lambda: [kb._ct_v(p, 13) for p in p16]),
             "B6": (kd, lambda: [kd.deband_m2_center(*a) for a in b6]),
             "B3": (kb, lambda: [kb.rt_blur_v_multi(p, 13, 5) for p in p16]),
             "B4": (kb, lambda: [kb.rt_blur_v(p, 23) for p in p16]),
             "B13": (kss, lambda: [kss.ssim_partials(*a) for a in b13]),
             "B7": (kc, lambda: [kc.clahe8_lookup(*b7)]),
             "B11": (kx, lambda: list(kx.luma_stats(*b11, 1, True))),
             "B12": (kx, lambda: kx.chroma_sse_uv(b12[0][0], b12[1][0], b12[0][1], b12[1][1],
                                                  32, 32))}
    built = {}
    for lib, old, new, which, *attrs in chosen:
        module, call = calls[which]
        # B12 and B13 by device time: their calls take less device time than
        # the host takes to issue them
        timed = ({"B12": lambda c: ks.device_ms(c, 10, "chroma_"), "B13": ks.device_ms}
                 .get(which, lambda c: ks.events_ms(c, 10)))
        src = _build.source(lib).read_text()
        if src.count(old) != 1:
            raise SystemExit(f"kernel_variants: {lib}: not found once: {old!r}")
        if (lib, new) not in built:
            built[lib, new] = ks.build(lib, src.replace(old, new), f"variant_{len(built)}")

        def on_copy(module=module, lib=lib, call=call, copy=built[lib, new],
                    attrs=attrs[0] if attrs else {}):
            return with_attrs(module, attrs, lambda: ks.using(lib, copy, call))

        if not ks._same(tuple(on_copy()), tuple(call())):
            raise SystemExit(f"kernel_variants: {new!r} disagrees with the package")
        t = [timed(call), timed(on_copy), timed(on_copy), timed(call)]
        print(f"{which} {new.strip()}: {(t[1] + t[2]) / 2:.3f} ms against the package's "
              f"{(t[0] + t[3]) / 2:.3f} ms ({', '.join(f'{v:.3f}' for v in t)})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
