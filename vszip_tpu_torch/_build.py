"""Build and load the port's native libraries.

Every library is one source file compiled into a shared library with a plain
C interface and loaded with ``ctypes``:

====================  ===================================  =====================
library               source                               compiler
====================  ===================================  =====================
``boxblur``           ``csrc/boxblur.cu``                  nvcc (``sm_90a``)
``deband``            ``csrc/deband.cu``                   nvcc (``sm_90a``)
``clahe``             ``csrc/clahe.cu``                    nvcc (``sm_90a``)
``eedi3``             ``csrc/eedi3.cu``                    nvcc (``sm_90a``)
``xpsnr``             ``csrc/xpsnr.cu``                    nvcc (``sm_90a``)
``ssim``              ``csrc/ssim.cu``                     nvcc (``sm_90a``)
``bilateral_dither``  ``csrc/bilateral_dither.cu``         nvcc (``sm_90a``)
``bilateral``         ``csrc/bilateral.cu``                nvcc (``sm_90a``)
``compress``          ``csrc/compress.cu``                 nvcc (``sm_90a``)
``checkmate``         ``csrc/checkmate.cu``                nvcc (``sm_90a``)
``comb_mask``         ``csrc/comb_mask.cu``                nvcc (``sm_90a``)
``deband_rng``        ``runtime/native/deband_rng.cpp``    g++
``dither``            ``runtime/native/dither.cpp``        g++
``png_unfilter``      ``runtime/native/png_unfilter.cpp``  g++
====================  ===================================  =====================

Libraries go to ``build/vszip_tpu_torch/<name>_<hash>.so`` at the root of
the checkout, keyed by a hash of the source and the flags, never beside the
source.  Nothing builds at import: a library is compiled at its first use,
or ahead of time by ``build(*names)``, which starts one compiler per source,
all at once.  A failed build raises; there is no prebuilt fallback.  The
compiler's output (for nvcc, ptxas' registers per kernel) is kept beside the
library as ``.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from functools import lru_cache
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent
BUILD_DIR = PACKAGE.parent / "build" / "vszip_tpu_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O2", "-fPIC", "-shared")

# name -> (source relative to the package, extra flags).  deband.cu's mode 6
# (the VCL pow polynomial), CLAHE's blend, EEDI3's cost, DP and
# interpolation, SSIMULACRA2's blurs and maps, BilateralDither's tap sums and
# Bilateral's window sums pin their f32 order:
# -fmad=false stops nvcc contracting a*b+c into FMA, so they round as the
# plain torch versions.
LIBRARIES = {
    "boxblur": ("csrc/boxblur.cu", ()),
    "deband": ("csrc/deband.cu", ("-fmad=false",)),
    "clahe": ("csrc/clahe.cu", ("-fmad=false",)),
    "eedi3": ("csrc/eedi3.cu", ("-fmad=false",)),
    "xpsnr": ("csrc/xpsnr.cu", ()),
    "ssim": ("csrc/ssim.cu", ("-fmad=false",)),
    "bilateral_dither": ("csrc/bilateral_dither.cu", ("-fmad=false",)),
    "bilateral": ("csrc/bilateral.cu", ("-fmad=false",)),
    # integer only: nothing to contract
    "compress": ("csrc/compress.cu", ()),
    "checkmate": ("csrc/checkmate.cu", ()),
    "comb_mask": ("csrc/comb_mask.cu", ()),
    "deband_rng": ("runtime/native/deband_rng.cpp", ()),
    "dither": ("runtime/native/dither.cpp", ()),
    "png_unfilter": ("runtime/native/png_unfilter.cpp", ()),
}

# seconds from the start of a build() call until each library's compiler
# finished, for the libraries that call compiled
BUILD_SECONDS: dict[str, float] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("vszip_tpu_torch: no CUDA toolkit found (set CUDA_HOME)")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"vszip_tpu_torch: {nvcc} not found")
    return str(nvcc)


def _flags(name: str) -> tuple[str, ...]:
    source, extra = LIBRARIES[name]
    return (NVCC_FLAGS if source.endswith(".cu") else GXX_FLAGS) + extra


def source(name: str) -> Path:
    return PACKAGE / LIBRARIES[name][0]


def library_path(name: str) -> Path:
    """Where library `name` for the current source and flags lives."""
    h = hashlib.sha256(" ".join(_flags(name)).encode())
    h.update(source(name).read_bytes())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def build(*names: str) -> dict[str, Path]:
    """Compile every library in `names` that is not built yet, one compiler
    process per source, all started together; returns name -> path.  The
    seconds each compiler ran go to ``BUILD_SECONDS``."""
    paths = {name: library_path(name) for name in names}
    cmds = {}
    for name, so in paths.items():
        if not so.exists():
            compiler = _nvcc() if source(name).suffix == ".cu" else "g++"
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmds[name] = ([compiler, *_flags(name), "-o", str(tmp), str(source(name))], tmp)
    if not cmds:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    running = {}
    for name, (cmd, tmp) in cmds.items():
        log = open(paths[name].with_suffix(".log"), "w")
        try:
            running[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                             log, tmp)
        except FileNotFoundError as e:
            log.close()
            for proc, f, _ in running.values():
                proc.wait()
                f.close()
            raise RuntimeError(f"vszip_tpu_torch: {cmd[0]} not found") from e
    failed = []
    while running:
        for name, (proc, log, tmp) in list(running.items()):
            if proc.poll() is None:
                continue
            BUILD_SECONDS[name] = time.perf_counter() - t0
            log.close()
            del running[name]
            if proc.returncode != 0:
                out = paths[name].with_suffix(".log").read_text()
                failed.append(f"{name} ({proc.returncode}):\n{out}")
            else:
                os.replace(tmp, paths[name])
        time.sleep(0.02)
    if failed:
        raise RuntimeError("vszip_tpu_torch: build failed: " + "\n".join(failed))
    return paths


@lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Library `name`, built first if need be."""
    return ctypes.CDLL(str(build(name)[name]))


def stream(x) -> int:
    """The handle of the current CUDA stream on `x`'s device."""
    import torch

    return torch.cuda.current_stream(x.device).cuda_stream


def check(fn, *args) -> None:
    """Call a kernel entry point; raise if it returns a CUDA error code."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"vszip_tpu_torch: {fn.__name__} failed with CUDA error {err}")
