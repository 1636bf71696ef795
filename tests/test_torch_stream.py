"""The port's streaming runtime on the CPU (``device="cpu"``): each test of
tests/test_stream.py but the mesh one (tests/test_torch_parallel.py holds
that), with the port's streamed output held against the JAX package's
resident output, plus the port's own surface (a ``mesh`` that is not a
``frames_mesh`` raises, a sink that keeps every chunk, no card for
``device="cuda"``).

Tolerances: planes bit-exact, per-frame props equal, XPSNR's average within
rtol 1e-12 (the port's and the JAX package's f64 log10 and sums may round
their last bit differently).
"""

import numpy as np
import pytest
import torch

import vszip_tpu as vz
import vszip_tpu_torch as vt
from vszip_tpu.ops.boxblur import boxblur as j_boxblur
from vszip_tpu.ops.checkmate import checkmate as j_checkmate
from vszip_tpu.ops.eedi3 import eedi3 as j_eedi3
from vszip_tpu.ops.planeaverage import plane_average as j_avg
from vszip_tpu.ops.xpsnr import xpsnr as j_xpsnr

CPU = {"device": "cpu"}


def _planes(n=13, h=48, w=64, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, 65536, (n, h, w), dtype=np.uint16),
        rng.integers(0, 65536, (n, h // 2, w // 2), dtype=np.uint16),
        rng.integers(0, 65536, (n, h // 2, w // 2), dtype=np.uint16),
    )


@pytest.fixture()
def src():
    return vt.ArraySource(_planes(), vt.get_format("YUV420P16"))


def _resident(planes, fmt_name):
    return vz.Clip.from_planes(planes, vz.get_format(fmt_name))


def _clip(planes, fmt_name):
    return vt.Clip.from_planes(planes, vt.get_format(fmt_name), device="cpu")


def _collect(fmt):
    chunks = {}

    def sink(start, clip):
        chunks[start] = clip

    def assemble():
        planes = []
        for p in range(fmt.num_planes):
            planes.append(np.concatenate(
                [chunks[s].planes[p] for s in sorted(chunks)]))
        return planes

    return sink, assemble, chunks


def test_spatial_op_matches_resident(src):
    resident = j_boxblur(_resident(src.planes, "YUV420P16"), hradius=3, vradius=2)
    sink, assemble, _ = _collect(src.format)
    vt.process_stream(src, lambda c: vt.boxblur(c, hradius=3, vradius=2), batch=4,
                      sink=sink, **CPU)
    for got, want in zip(assemble(), resident.planes):
        assert got.dtype == np.uint16
        np.testing.assert_array_equal(got, np.asarray(want))


def test_temporal_op_overlap_matches_resident():
    planes = tuple((p >> 8).astype(np.uint8) for p in _planes())
    src = vt.ArraySource(planes, vt.get_format("YUV420P8"))
    resident = j_checkmate(_resident(planes, "YUV420P8"), thr=12, tmax=12, tthr2=8)
    sink, assemble, _ = _collect(src.format)
    vt.process_stream(src, lambda c: vt.checkmate(c, thr=12, tmax=12, tthr2=8),
                      batch=4, overlap=2, sink=sink, **CPU)
    for got, want in zip(assemble(), resident.planes):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_metric_props_accumulate(src):
    resident = j_avg(_resident(src.planes, "YUV420P16"), exclude=[-1])
    props = vt.process_stream(src, lambda c: vt.plane_average(c, exclude=[-1]), batch=5,
                              **CPU)
    assert isinstance(props["psmAvg"], np.ndarray)
    np.testing.assert_array_equal(props["psmAvg"], np.asarray(resident.props["psmAvg"]))


def test_synthetic_source_never_materializes():
    fmt = vt.get_format("GRAY16")
    calls = []

    def make(start, stop):
        calls.append((start, stop))
        rng = np.random.default_rng(start)
        return (rng.integers(0, 65536, (stop - start, 32, 48), np.uint16),)

    source = vt.SyntheticSource(make, fmt, num_frames=11)
    props = vt.process_stream(source, lambda c: vt.plane_average(c, exclude=[-1]),
                              batch=4, **CPU)
    assert props["psmAvg"].shape == (11, 1)
    assert calls == [(0, 4), (4, 8), (8, 11)]


def test_errors_match(src):
    empty_j = vz.ArraySource((np.zeros((0, 8, 8), np.uint16),), vz.get_format("GRAY16"))
    empty_t = vt.ArraySource((np.zeros((0, 8, 8), np.uint16),), vt.get_format("GRAY16"))
    jsrc = vz.ArraySource(src.planes, vz.get_format("YUV420P16"))
    for kw in ({"batch": 0}, {"batch": -2}, {"overlap": -1}):
        with pytest.raises(vz.VSZipError) as ej:
            vz.process_stream(jsrc, lambda c: c, **kw)
        with pytest.raises(vt.VSZipError) as et:
            vt.process_stream(src, lambda c: c, **kw, **CPU)
        assert str(ej.value) == str(et.value)
    with pytest.raises(vz.VSZipError) as ej:
        vz.process_stream(empty_j, lambda c: c)
    with pytest.raises(vt.VSZipError) as et:
        vt.process_stream(empty_t, lambda c: c, **CPU)
    assert str(ej.value) == str(et.value) == "process_stream: empty source."


def _xpsnr_pair(seed, n, h, w):
    rng = np.random.default_rng(seed)
    ref_p = tuple(rng.integers(0, 256, (n, h >> s, w >> s), dtype=np.uint8) for s in (0, 1, 1))
    dist_p = tuple(np.clip(p.astype(np.int32) + rng.integers(-9, 9, p.shape), 0, 255)
                   .astype(np.uint8) for p in ref_p)
    return ref_p, dist_p


def test_streamed_xpsnr_avg_matches_resident():
    """The end-of-run XPSNR average accumulates across all chunks."""
    n, h, w = 13, 48, 64
    ref_p, dist_p = _xpsnr_pair(3, n, h, w)
    resident = j_xpsnr(_resident(ref_p, "YUV420P8"), _resident(dist_p, "YUV420P8"), fps=24)

    batch, overlap = 4, 2
    idx = iter(range(0, n, batch))

    def op(chunk):
        start = next(idx)
        lo = max(0, start - overlap)
        hi = min(n, start + batch + overlap)
        return vt.xpsnr(_clip(tuple(p[lo:hi] for p in ref_p), "YUV420P8"), chunk, fps=24)

    props = vt.process_stream(vt.ArraySource(dist_p, vt.get_format("YUV420P8")), op,
                              batch=batch, overlap=overlap, donate=False, **CPU)
    for k in ("XPSNR_Y", "XPSNR_U", "XPSNR_V"):
        np.testing.assert_allclose(props[k], np.asarray(resident.props[k]), rtol=1e-12)
    np.testing.assert_allclose(props["XPSNR_AVG"], np.asarray(resident.props["XPSNR_AVG"]),
                               rtol=1e-12)
    assert "_XPSNR_WSSE" not in props and "_XPSNR_Num64" not in props
    # and it equals the port's own resident run on the same device, bit for bit
    own = vt.xpsnr(_clip(ref_p, "YUV420P8"), _clip(dist_p, "YUV420P8"), fps=24)
    np.testing.assert_array_equal(props["XPSNR_AVG"], own.props["XPSNR_AVG"].numpy())
    np.testing.assert_array_equal(props["XPSNR_Y"], own.props["XPSNR_Y"].numpy())


def test_streamed_frame_doubling_eedi3_matches_resident():
    """EEDI3 field=2 doubles the frame count: chunk halo trimming scales by
    the output/input frame ratio (held against the port's own resident run
    bit for bit, and the JAX package's under the EEDI3 contract)."""
    rng = np.random.default_rng(5)
    x = rng.random((7, 24, 32), dtype=np.float32)
    fmt = vt.get_format("GRAYS")
    own = vt.eedi3(_clip((x,), "GRAYS"), field=2).planes[0].numpy()
    sink, assemble, _ = _collect(fmt)
    vt.process_stream(vt.ArraySource((x,), fmt), lambda c: vt.eedi3(c, field=2), batch=3,
                      sink=sink, donate=False, **CPU)
    got = assemble()[0]
    np.testing.assert_array_equal(got, own)
    want = np.asarray(j_eedi3(_resident((x,), "GRAYS"), field=2).planes[0])
    assert np.abs(got - want).max() < 2e-6


def test_frame_doubling_sink_index_in_output_units():
    """Sink indices are in output-frame units: a frame-doubling op's chunk
    starting at source frame s lands at output frame 2*s."""
    rng = np.random.default_rng(6)
    x = rng.random((7, 24, 32), dtype=np.float32)
    fmt = vt.get_format("GRAYS")
    resident = vt.eedi3(_clip((x,), "GRAYS"), field=2).planes[0].numpy()
    out = np.full_like(resident, np.nan)
    starts = []

    def sink(start, clip):
        chunk = clip.planes[0]
        starts.append(start)
        out[start: start + chunk.shape[0]] = chunk

    vt.process_stream(vt.ArraySource((x,), fmt), lambda c: vt.eedi3(c, field=2), batch=3,
                      sink=sink, donate=False, **CPU)
    assert starts == [0, 6, 12]
    np.testing.assert_array_equal(out, resident)


def test_sink_does_not_see_internal_props():
    ref_p, dist_p = _xpsnr_pair(7, 6, 16, 16)
    seen = []

    def op(chunk):
        r = _clip(tuple(a[: chunk.planes[0].shape[0]] for a in ref_p), "YUV420P8")
        return vt.xpsnr(r, chunk, fps=24)

    def sink(start, clip):
        seen.append(set(clip.props))

    vt.process_stream(vt.ArraySource(dist_p, vt.get_format("YUV420P8")), op, batch=6,
                      sink=sink, donate=False, **CPU)
    assert seen and all(not any(k.startswith("_XPSNR_") for k in ks) for ks in seen)
    assert all("XPSNR_Y" in ks for ks in seen)


def test_streamed_non_multiple_frame_change_rejected(src):
    def bad(c):
        return c.with_planes(tuple(p[:-1] for p in c.planes))

    with pytest.raises(vt.VSZipError, match="frame count"):
        vt.process_stream(src, bad, batch=4, donate=False, **CPU)


def test_mesh_raises(src):
    """``mesh`` takes a ``parallel.frames_mesh``; anything else raises."""
    for mesh in (object(), ["cpu", "cpu"]):
        with pytest.raises(vt.VSZipError, match="mesh must be a parallel.frames_mesh"):
            vt.process_stream(src, lambda c: c, mesh=mesh)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the error without a card")
def test_cuda_without_a_card_raises(src):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vt.process_stream(src, lambda c: c)


@pytest.mark.parametrize("batch,overlap", [(4, 0), (5, 2), (13, 1), (20, 0)])
def test_sink_keeps_distinct_intact_planes(src, batch, overlap):
    """A sink that keeps every chunk (here the op returns its input planes
    unchanged, and the source's arrays are writable) sees fresh arrays whose
    frames are the source's, untouched by later chunks or by writes to the
    source after the call; per-frame props come trimmed like the planes."""
    sink, assemble, chunks = _collect(src.format)
    props = vt.process_stream(src, lambda c: vt.plane_average(c), batch=batch, overlap=overlap,
                              sink=sink, **CPU)
    expect = list(range(0, 13, batch))
    assert sorted(chunks) == expect
    before = [p.copy() for p in src.planes]
    for p in src.planes:
        p[...] = 0
    for s, clip in chunks.items():
        n = min(batch, 13 - s)
        for p, plane in enumerate(clip.planes):
            assert isinstance(plane, np.ndarray)
            np.testing.assert_array_equal(plane, before[p][s: s + n])
        assert clip.props["psmAvg"].shape == (n, 1)
    kept = [plane for clip in chunks.values() for plane in clip.planes]
    for i, a in enumerate(kept):
        assert not any(np.shares_memory(a, b) for b in kept[i + 1:] + list(src.planes))
    assert props["psmAvg"].shape == (13, 1)


def test_memory_mapped_source(tmp_path):
    planes = _planes(n=9, seed=4)
    fmt = vt.get_format("YUV420P16")
    maps = []
    for i, p in enumerate(planes):
        m = np.lib.format.open_memmap(tmp_path / f"p{i}.npy", mode="w+", dtype=p.dtype,
                                      shape=p.shape)
        m[...] = p
        m.flush()
        maps.append(np.load(tmp_path / f"p{i}.npy", mmap_mode="r"))
    resident = j_boxblur(_resident(planes, "YUV420P16"), hradius=2, vradius=2)
    sink, assemble, _ = _collect(fmt)
    vt.process_stream(vt.ArraySource(maps, fmt), lambda c: vt.boxblur(c, hradius=2, vradius=2),
                      batch=4, sink=sink, **CPU)
    for got, want in zip(assemble(), resident.planes):
        np.testing.assert_array_equal(got, np.asarray(want))
