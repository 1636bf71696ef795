#!/usr/bin/env python3
"""Where EEDI3's line kernel (B8/B9, ``vszip_tpu_torch/csrc/eedi3.cu``)
spends its time, on one NVIDIA GPU:

    python3 tools/eedi3_phases.py vszip_tpu_torch/csrc/eedi3.cu
    git show <commit>:vszip_tpu_torch/csrc/eedi3.cu > old.cu && python3 tools/eedi3_phases.py old.cu

It copies the given source, inserts ``clock64()`` spans at fixed lines of
the kernel, builds the copy and the unchanged source with the package's
nvcc flags into ``build/eedi3_phases/``, and runs both on the bench's EEDI3
rows (8 x 540 lines of w = 1920, mdis 20, nrad 2, uniform random rows;
non-hp, masked and hp), holding the copy's output equal to the unchanged
build's.  Two versions of the kernel are known, told apart by those lines:

- sequential (one 128-thread block per line, the phases in turn): thread 0
  reads the clock after each phase's ``__syncthreads``, so a phase includes
  the wait for its slowest warp: cost build, DP, backtrack, interpolation;
- warp-specialised (producer warps and one DP warp per line): the block's
  time while the roles run, the DP warp's waits for a full cost buffer,
  producer warp 0's waits for an empty one and at the producers' end-of-chunk
  barrier, then the backtrack and the interpolation.

It prints, per instantiation, the kernel's time by CUDA events (unchanged
build), the mean cycles per block of each span, the resident blocks per SM
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and ptxas' registers.
"""

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from vszip_tpu_torch import _build  # noqa: E402
from vszip_tpu_torch.kernels import eedi3 as ke  # noqa: E402
from vszip_tpu_torch.ops.eedi3 import _pad_rows  # noqa: E402

OUT = ROOT / "build" / "eedi3_phases"
W, MDIS, NRAD = 1920, 20, 2
COEFS = tuple(float(np.float32(v)) for v in (0.2 / 3, 0.25 / 255, 20.0 / 255)) + (
    float(np.float32(1.0) - np.float32(0.2) - np.float32(0.25)),)
SLOTS = 8  # the probe's counters: the spans, and the block count last

KERNEL_END = "      orow[x] = res;\n    }\n  }\n}\n"
HEADER = "namespace {\n"
HEADER_NEW = f"__device__ unsigned long long g_phase[{SLOTS}];\n\nnamespace {{\n"


def _add(slot: int, value: str, who: str = "threadIdx.x == 0") -> str:
    return f"if ({who}) atomicAdd(&g_phase[{slot}], (unsigned long long)({value}));"


# version -> (span names, ((anchor, code inserted before it), ...), code at
# the kernel's end, (the occupancy query's hp, masked and plain kernels,
# its threads per block))
VERSIONS = {
    "sequential": (
        ("cost build", "DP", "backtrack", "interpolation"),
        (("  extern __shared__ float smem[];\n",
          "  long long ph_c = 0, ph_d = 0, ph_b = 0, ph_m = clock64();\n"),
         ("    // ---- the chunk's costs, one direction per warp at a time ----\n",
          "    ph_m = clock64();\n"),
         ("    // ---- the DP over the chunk: warp 0, lanes over directions ----\n",
          "    ph_c += clock64() - ph_m;\n    ph_m = clock64();\n"),
         ("  }\n\n  // ---- backtrack: fpath[w-1] = 0, fpath[x] = f(x+1) + delta(x+1) ----\n",
          "    ph_d += clock64() - ph_m;\n"),
         ("  // ---- backtrack: fpath[w-1] = 0, fpath[x] = f(x+1) + delta(x+1) ----\n",
          "  ph_m = clock64();\n"),
         ("  // ---- directional interpolation ----\n",
          "  ph_b += clock64() - ph_m;\n  ph_m = clock64();\n")),
        "  __syncthreads();\n  {} {} {} {}\n".format(
            _add(0, "ph_c"), _add(1, "ph_d"), _add(2, "ph_b"), _add(3, "clock64() - ph_m")),
        ("eedi3_line_kernel<true, false>", "eedi3_line_kernel<false, true>",
         "eedi3_line_kernel<false, false>", "kThreads"),
    ),
    "warp-specialised": (
        ("roles (producers and DP)", "DP waits for costs", "producer 0 waits for a buffer",
         "producer 0 waits at chunk end", "backtrack", "interpolation"),
        (("    if (c > 0) bar_sync_pair<kBarFull, Sh::threads>(buf);\n",
          "    const long long ph_w = clock64();\n"),
         ("    const float* Cb = C + buf * kXc * tp + t0;\n",
          f"    {_add(1, 'clock64() - ph_w', 'lane == 0')}\n"),
         ("    if (c >= 2) bar_sync_pair<kBarEmpty, Sh::threads>(buf);  "
          "// the DP is done with chunk c-2\n",
          "    const long long ph_e = clock64();\n"),
         ("    const int x0 = c * kXc, cn = min(kXc, w - x0);\n    float* Cb = C + buf * kXc * tp;\n",
          f"    {_add(2, 'clock64() - ph_e')}\n"),
         ("    cp_async_wait_all();  // chunk c+1's windows are in; nobody reads chunk c's any more\n",
          "    const long long ph_p = clock64();\n"),
         ("    if (threadIdx.x == 0) queue[buf] = 0;  // for chunk c+2\n",
          f"    {_add(3, 'clock64() - ph_p')}\n"),
         ("  if (warp < Sh::prod) {\n", "  long long ph_m = clock64();\n"),
         ("  // ---- backtrack by chunks: fpath[w-1] = 0, fpath[x-1] = f(x) + delta(x) ----\n",
          f"  {_add(0, 'clock64() - ph_m')}\n  ph_m = clock64();\n"),
         ("  // ---- directional interpolation ----\n",
          f"  {_add(4, 'clock64() - ph_m')}\n  ph_m = clock64();\n")),
        f"  __syncthreads();\n  {_add(5, 'clock64() - ph_m')}\n",
        ("eedi3_line_kernel<true, false, 3>", "eedi3_line_kernel<false, true, 2>",
         "eedi3_line_kernel<false, false, 2>",
         "(hp ? Shape<true>::threads : Shape<false>::threads)"),
    ),
}

TAIL = """
extern "C" int vz_probe_read(unsigned long long* out) {{
  cudaError_t e = cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
  if (e != cudaSuccess) return (int)e;
  unsigned long long zero[{slots}] = {{0}};
  return (int)cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
}}

extern "C" int vz_probe_occupancy(int w, int mdis, int hp, int mask, int* blocks) {{
  const Plan P = plan(w, mdis, hp != 0);
  const size_t bytes = P.base_bytes + (P.bt_smem ? 4 * (size_t)P.bt_words : 0);
  const void* k = hp ? (const void*){hp_k} : mask ? (const void*){mask_k} : (const void*){k};
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, {threads}, bytes);
}}
"""


def instrument(src: str) -> tuple[str, tuple[str, ...]]:
    """`src` with the spans of its version, the counters and the probe's
    entry points, and the span names; exits if the source is neither."""
    for version, (names, spans, end, kernels) in VERSIONS.items():
        anchors = [a for a, _ in spans] + [KERNEL_END, HEADER]
        if all(src.count(a) == 1 for a in anchors):
            break
    else:
        raise SystemExit("eedi3_phases: the source is none of the known kernel versions")
    for anchor, code in spans:
        src = src.replace(anchor, code + anchor)
    end += f"  {_add(SLOTS - 1, '1')}\n"
    src = src.replace(KERNEL_END, KERNEL_END[:-2] + end + "}\n").replace(HEADER, HEADER_NEW, 1)
    hp_k, mask_k, k, threads = kernels
    print(f"kernel version: {version}")
    return src + TAIL.format(slots=SLOTS, hp_k=hp_k, mask_k=mask_k, k=k, threads=threads), names


def build(src_path: Path, name: str) -> ctypes.CDLL:
    so = OUT / f"{name}.so"
    log = subprocess.run([_build._nvcc(), *_build._flags("eedi3"), "-o", str(so), str(src_path)],
                         capture_output=True, text=True)
    (OUT / f"{name}.log").write_text(log.stdout + log.stderr)
    if log.returncode != 0:
        raise SystemExit(f"eedi3_phases: build of {name} failed:\n{log.stdout}{log.stderr}")
    lib = ctypes.CDLL(str(so))
    p, i, f, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
    lib.vz_eedi3_scratch_words.argtypes = [i, i, i]
    lib.vz_eedi3_scratch_words.restype = ctypes.c_longlong
    lib.vz_eedi3_fused.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, f, d, f, f, f, p]
    lib.vz_eedi3_fused.restype = ctypes.c_int
    return lib


def registers(name: str) -> list[str]:
    """ptxas' 'Used ...' line of each line-kernel instantiation."""
    out, fn = [], None
    for line in (OUT / f"{name}.log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        elif "Used" in line and fn and "eedi3_line_kernel" in fn:
            args = re.search(r"eedi3_line_kernelILb(\d)ELb(\d)E(?:Li(\d)E)?", fn)
            out.append(f"<{','.join(a for a in args.groups() if a)}>: "
                       f"{line.split(':', 1)[-1].strip()}")
    return out


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("eedi3_phases: no CUDA device", file=sys.stderr)
        return 1
    src_path = Path(sys.argv[1]).resolve()
    OUT.mkdir(parents=True, exist_ok=True)
    probe_src = OUT / "eedi3_probe.cu"
    text, names = instrument(src_path.read_text())
    probe_src.write_text(text)
    plain_lib, probe_lib = build(src_path, "eedi3_plain"), build(probe_src, "eedi3_probe")
    probe_lib.vz_probe_read.argtypes = [ctypes.c_void_p]
    probe_lib.vz_probe_occupancy.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {smi.strip()}")
    print("registers (unchanged build):", "; ".join(registers("eedi3_plain")))
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    rows = [_pad_rows(torch.rand((8, 540, W), generator=g, device=dev)).contiguous()
            for _ in range(4)]
    mask = torch.rand((8, 540, W), generator=g, device=dev) > 0.3
    for label, hp, bm in (("B8", False, None), ("B8 with mclip", False, mask),
                          ("B9 (hp)", True, None)):
        fn = ke.eedi3_fused_hp if hp else ke.eedi3_fused
        args = (*rows, W, MDIS, NRAD, *COEFS) + (() if hp else (bm,))
        saved = ke._lib
        try:
            ke._lib = lambda: plain_lib
            for _ in range(2):
                want = fn(*args)
            torch.cuda.synchronize()
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(5):
                fn(*args)
            t1.record()
            torch.cuda.synchronize()
            ms = t0.elapsed_time(t1) / 5
            ke._lib = lambda: probe_lib
            buf = (ctypes.c_ulonglong * SLOTS)()
            probe_lib.vz_probe_read(buf)
            got = fn(*args)
            torch.cuda.synchronize()
            probe_lib.vz_probe_read(buf)
        finally:
            ke._lib = saved
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise SystemExit(f"eedi3_phases: {label}: the instrumented kernel disagrees")
        blocks = ctypes.c_int()
        err = probe_lib.vz_probe_occupancy(W, MDIS, int(hp), int(bm is not None),
                                           ctypes.byref(blocks))
        if err:
            raise SystemExit(f"eedi3_phases: occupancy query failed ({err})")
        n = buf[SLOTS - 1]
        spans = ", ".join(f"{name} {buf[i] / n:,.0f}" for i, name in enumerate(names))
        print(f"{label}: {ms:.3f} ms; {n} blocks, {blocks.value} resident per SM; "
              f"cycles per block: {spans}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
