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
``mosquito_nr``       ``csrc/mosquito_nr.cu``              nvcc (``sm_90a``)
``deband_rng``        ``runtime/native/deband_rng.cpp``    g++
``dither``            ``runtime/native/dither.cpp``        g++
``png_unfilter``      ``runtime/native/png_unfilter.cpp``  g++
====================  ===================================  =====================

Libraries go to ``build/vszip_tpu_torch/<name>_<hash>.so`` at the root of
the checkout, keyed by a hash of the flags, the source and every header it
includes by a quoted ``#include`` (``csrc/common.cuh``), never beside the
source.  Nothing builds at import: a library is compiled at its first use,
or ahead of time by ``build(*names)``, which starts one compiler per source,
all at once.  A failed build raises; there is no prebuilt fallback.  The
compiler's output (for nvcc, ptxas' registers per kernel) is kept beside the
library as ``.log``.

Python reaches a library only through entry points declared once with
``entry`` (a plain call: the host libraries and the CUDA libraries' queries)
or ``kernel`` (a launch: it enters the device, passes its current stream and
raises on a CUDA error).  Each resolves its symbol at its first call and
keeps it; ``bind`` points a library's entry points at another build of it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import time
from functools import lru_cache
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parent
BUILD_DIR = PACKAGE.parent / "build" / "vszip_tpu_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O2", "-fPIC", "-shared")

# A block's dynamic shared memory at most on sm_90 (227 KB): csrc/common.cuh
# kMaxSmemBytes, which the wrappers' size rules read here.
MAX_SMEM_BYTES = 232448

# name -> (source relative to the package, extra flags).  deband.cu's mode 6
# (the VCL pow polynomial), CLAHE's blend, EEDI3's cost, DP and
# interpolation, SSIMULACRA2's blurs and maps, BilateralDither's tap sums,
# Bilateral's window sums and MosquitoNR's f32 SADs and blend pin their f32
# order:
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
    "mosquito_nr": ("csrc/mosquito_nr.cu", ("-fmad=false",)),
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


def _sources(path: Path) -> list[Path]:
    """`path` and every file it includes by a quoted ``#include``, resolved
    beside the file that includes it, each once, in the order first met."""
    seen = [path]
    for p in seen:
        for inc in re.findall(r'^\s*#\s*include\s+"([^"]+)"', p.read_text(), re.M):
            q = (p.parent / inc).resolve()
            if q not in seen:
                seen.append(q)
    return seen


def library_path(name: str) -> Path:
    """Where library `name` for the current flags, source and headers lives."""
    h = hashlib.sha256(" ".join(_flags(name)).encode())
    for path in _sources(source(name)):
        h.update(path.read_bytes())
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


# every declared entry point, in declaration order
ENTRIES: list[Entry] = []


class Entry:
    """Entry point `symbol` of library `library`, declared once with its C
    argument types and return type.  Calling it calls the symbol with the
    arguments as given and returns its result; the symbol is resolved at the
    first call (building the library if need be) and kept."""

    __slots__ = ("library", "symbol", "argtypes", "restype", "fn")

    def __init__(self, library: str, symbol: str, argtypes: tuple, restype) -> None:
        self.library, self.symbol = library, symbol
        self.argtypes, self.restype = argtypes, restype
        self.fn = None
        ENTRIES.append(self)

    def bind(self, lib: ctypes.CDLL | None) -> None:
        """Resolve the symbol in `lib`; None: in the package's build at the
        next call."""
        if lib is None:
            self.fn = None
            return
        fn = getattr(lib, self.symbol)
        fn.argtypes, fn.restype = self.argtypes, self.restype
        self.fn = fn

    def __call__(self, *args):
        if self.fn is None:
            self.bind(load(self.library))
        return self.fn(*args)


class Kernel(Entry):
    """An entry point that launches CUDA work and returns its CUDA error code,
    its last C argument the stream.  ``k(device, *args)`` enters `device`,
    calls the symbol with `args` and that device's current stream, and raises
    ``RuntimeError`` naming the symbol on a non-zero code."""

    __slots__ = ()

    def __call__(self, device, *args) -> None:
        if self.fn is None:
            self.bind(load(self.library))
        with torch.cuda.device(device):
            err = self.fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"vszip_tpu_torch: {self.symbol} failed with CUDA error {err}")


def entry(library: str, symbol: str, *argtypes, restype=ctypes.c_int) -> Entry:
    """Declare a plain call of `symbol` in `library` (C argument types
    `argtypes`, return type `restype`; None for void)."""
    return Entry(library, symbol, argtypes, restype)


def kernel(library: str, symbol: str, *argtypes) -> Kernel:
    """Declare a launch of `symbol` in CUDA library `library`: `argtypes`
    are its C argument types before the stream, which the call appends."""
    return Kernel(library, symbol, (*argtypes, ctypes.c_void_p), ctypes.c_int)


def bind(library: str, lib: ctypes.CDLL | None = None) -> None:
    """Resolve every declared entry point of `library` in `lib`, a build of a
    copy of its source (tools run the package's wrappers on such copies);
    None: in the package's own build again, at each one's next call."""
    for e in ENTRIES:
        if e.library == library:
            e.bind(lib)
