"""The seam between the port's Python and its native libraries
(``vszip_tpu_torch._build``), on the CPU: every declared entry point against
its C signature, the library path's hash over the headers a source includes,
and an entry point's resolution, once, into the package's build or another."""

import ctypes
import importlib
import re
import shutil
import types

import numpy as np
import pytest

from vszip_tpu_torch import _build

MODULES = [f"vszip_tpu_torch.kernels.{m}" for m in (
    "bilateral", "bilateral_dither", "boxblur", "checkmate", "clahe", "comb_mask", "compress",
    "deband", "eedi3", "mosquito_nr", "ssim", "xpsnr")] + [f"vszip_tpu_torch.runtime.{m}" for m in (
        "deband_rng", "dither", "png_native")]
for _m in MODULES:
    importlib.import_module(_m)

# a C scalar type -> (kind, bytes, signed)
C_SCALARS = {"int": ("i", 4, True), "int32_t": ("i", 4, True), "unsigned": ("i", 4, False),
             "uint32_t": ("i", 4, False), "long long": ("i", 8, True), "int16_t": ("i", 2, True),
             "uint16_t": ("i", 2, False), "uint8_t": ("i", 1, False), "float": ("f", 4, True),
             "double": ("f", 8, True)}


def _c_signature(entry):
    """(return type, [parameter declarations]) of `entry`'s symbol in its source."""
    src = _build.source(entry.library).read_text()
    found = re.findall(r"([\w ]+?)\s*\b" + entry.symbol + r"\s*\(([^)]*)\)\s*\{", src)
    assert len(found) == 1, f"{entry.symbol}: {len(found)} definitions"
    ret, params = found[0]
    ret = "long long" if ret.endswith("long long") else ret.split()[-1]
    return ret, [p.strip() for p in params.split(",")]


def _c_kind(decl: str):
    """A C parameter declaration as ("p", pointee kind or None) or a scalar kind."""
    if "*" in decl:
        base = decl.split("*")[0].replace("const", "").strip()
        return "p", C_SCALARS.get(base)
    return C_SCALARS[" ".join(w for w in decl.split()[:-1] if w != "const")]


def _ctypes_kind(t):
    if t is ctypes.c_void_p:
        return "p", None
    if issubclass(t, ctypes._Pointer):
        return "p", _ctypes_kind(t._type_)
    if t in (ctypes.c_float, ctypes.c_double):
        return "f", ctypes.sizeof(t), True
    return "i", ctypes.sizeof(t), t(-1).value < 0


@pytest.mark.parametrize("entry", _build.ENTRIES, ids=lambda e: e.symbol)
def test_every_entry_point_matches_its_c_signature(entry):
    """An argument type that disagrees with the C side fails silently (an int
    where C takes long long is truncated): each declaration is held to the
    source, pointers to pointers (void* to any), a kernel's trailing stream
    included."""
    ret, params = _c_signature(entry)
    assert len(entry.argtypes) == len(params), entry.symbol
    for decl, t in zip(params, entry.argtypes):
        want, got = _c_kind(decl), _ctypes_kind(t)
        if want[0] == "p" and got == ("p", None):
            continue
        assert got == want, f"{entry.symbol}: {decl!r} declared as {t.__name__}"
    if isinstance(entry, _build.Kernel):
        assert params[-1] == "void* stream" and ret == "int", entry.symbol
    assert (entry.restype is None) == (ret == "void"), entry.symbol
    if entry.restype is not None:
        assert _ctypes_kind(entry.restype) == C_SCALARS[ret], entry.symbol


def test_every_cuda_entry_point_with_a_stream_is_a_kernel():
    """A CUDA entry point that takes a stream is declared as a launch, so it
    runs on its tensors' device and stream; every one the wrappers call is
    declared."""
    declared = {e.symbol: e for e in _build.ENTRIES}
    for name, (src, _) in _build.LIBRARIES.items():
        if not src.endswith(".cu"):
            continue
        text = _build.source(name).read_text()
        for symbol, params in re.findall(r"^\w[\w ]*\b(vz_\w+)\(([^)]*)\)\s*\{", text, re.M):
            assert symbol in declared, symbol
            assert isinstance(declared[symbol], _build.Kernel) == params.rstrip().endswith(
                "void* stream"), symbol


def test_max_smem_bytes_is_the_headers():
    text = (_build.PACKAGE / "csrc" / "common.cuh").read_text()
    assert int(re.search(r"kMaxSmemBytes = (\d+);", text).group(1)) == _build.MAX_SMEM_BYTES
    for name, (src, _) in _build.LIBRARIES.items():
        if src.endswith(".cu"):
            assert "kMaxSmemBytes = " not in _build.source(name).read_text(), name


@pytest.mark.parametrize("name,includes", [("boxblur", True), ("ssim", False)])
def test_a_header_edit_changes_the_library_path(monkeypatch, tmp_path, name, includes):
    """A library's path hashes every header its source includes, so a header
    edit never loads a stale build; a source that does not include it keeps
    its path."""
    shutil.copytree(_build.PACKAGE / "csrc", tmp_path / "csrc")
    monkeypatch.setattr(_build, "PACKAGE", tmp_path)
    path = _build.library_path(name)
    assert path == _build.library_path(name)
    assert [p.name for p in _build._sources(_build.source(name))][1:] == (
        ["common.cuh"] if includes else [])
    header = tmp_path / "csrc" / "common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert (_build.library_path(name) != path) is includes


def test_an_entry_point_resolves_once_and_binds_to_another_build(monkeypatch):
    """The first call builds and loads the library and keeps the symbol, with
    its argument types set; ``bind`` points the library's entry points at
    another build (tools time copies of a source so) and back."""
    from vszip_tpu_torch.runtime import png_native

    entry = png_native._UNFILTER
    loads = []
    real = _build.load
    monkeypatch.setattr(_build, "load", lambda name: loads.append(name) or real(name))
    _build.bind("png_unfilter")
    raw = bytes([0, 1, 2, 3, 1, 4, 5, 6])
    first = png_native.unfilter(raw, 2, 3, 1)
    np.testing.assert_array_equal(png_native.unfilter(raw, 2, 3, 1), first)
    assert loads == ["png_unfilter"] and entry.fn.argtypes == entry.argtypes
    calls = []

    def fake(*args):
        calls.append(args)
        return 0
    try:
        _build.bind("png_unfilter", types.SimpleNamespace(vszip_png_unfilter=fake))
        png_native.unfilter(raw, 2, 3, 1)
        assert len(calls) == 1 and fake.argtypes == entry.argtypes
    finally:
        _build.bind("png_unfilter")
    np.testing.assert_array_equal(png_native.unfilter(raw, 2, 3, 1), first)
    assert loads == ["png_unfilter"] * 2 and len(calls) == 1
