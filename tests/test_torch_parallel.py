"""The port's frame sharding (``vszip_tpu_torch.parallel``) and
``process_stream(mesh=...)`` on the CPU: each case of tests/test_parallel.py
and the mesh case of tests/test_stream.py.  The JAX side runs on its
8-device CPU mesh (tests/conftest.py), the port on
``frames_mesh(devices=["cpu"] * 8)`` (and smaller meshes), with the halo
each op's temporal radius needs.

Tolerances: the port's sharded and meshed runs equal its unsharded runs bit
for bit (planes and props, XPSNR's average included).  Against the JAX
package, the per-op contract: integer planes bit-exact, EEDI3 max |d| <
2e-6, XPSNR props rtol 1e-12, SSIMULACRA2 rtol 1e-3.
"""

import ast
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import vszip_tpu as vz
import vszip_tpu_torch as vt
from test_torch_core import assert_planes_match
from vszip_tpu.ops.boxblur import boxblur as j_boxblur
from vszip_tpu.ops.checkmate import checkmate as j_checkmate
from vszip_tpu.ops.eedi3 import eedi3 as j_eedi3
from vszip_tpu.ops.limiter import limiter as j_limiter
from vszip_tpu.ops.planeaverage import plane_average as j_avg
from vszip_tpu.ops.planeminmax import plane_minmax as j_minmax
from vszip_tpu.ops.ssimulacra2 import ssimulacra2 as j_ssim
from vszip_tpu.ops.xpsnr import xpsnr as j_xpsnr
from vszip_tpu.parallel.mesh import frames_mesh as j_frames_mesh
from vszip_tpu.parallel.mesh import shard_clip as j_shard_clip
from vszip_tpu_torch.parallel import frames_mesh, replicate_clip, run_sharded, shard_clip

ROOT = Path(__file__).resolve().parent.parent
CPU8 = frames_mesh(devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def jmesh():
    return j_frames_mesh(8)


def _clips(fmt_name, planes):
    return (vz.Clip.from_planes(planes, vz.get_format(fmt_name)),
            vt.Clip.from_planes(planes, vt.get_format(fmt_name), device="cpu"))


@pytest.fixture()
def clip8():
    rng = np.random.default_rng(7)
    planes = tuple(rng.integers(0, 256, (8, 48 >> (p > 0), 64 >> (p > 0)), dtype=np.uint8)
                   for p in range(3))
    return _clips("YUV420P8", planes)


def _same(got, want):
    """Port clips equal bit for bit: planes and props."""
    assert got.format == want.format and len(got.planes) == len(want.planes)
    for a, b in zip(got.planes, want.planes):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a.to(torch.int64),
                           b.view(torch.int32) if b.dtype == torch.float32 else b.to(torch.int64))
    assert set(got.props) == set(want.props)
    for k, v in want.props.items():
        g = got.props[k]
        if isinstance(v, torch.Tensor):
            assert g.dtype == v.dtype and g.shape == v.shape and torch.equal(g, v), k
        else:
            assert g == v, k


def test_spatial_filter_matches_unsharded(jmesh, clip8):
    jc, tc = clip8
    want = j_boxblur(jc, hradius=3, vradius=3)
    jout = jax.jit(lambda c: j_boxblur(c, hradius=3, vradius=3))(j_shard_clip(jc, jmesh))
    got = run_sharded(lambda c: vt.boxblur(c, hradius=3, vradius=3), tc, mesh=CPU8)
    _same(got, vt.boxblur(tc, hradius=3, vradius=3))
    assert_planes_match(got.planes, want.planes)
    assert_planes_match(got.planes, jout.planes)


def test_chained_pipeline_sharded(jmesh, clip8):
    jc, tc = clip8
    want = jax.jit(lambda c: j_limiter(j_boxblur(c, hradius=2, vradius=2), tv_range=True))(
        j_shard_clip(jc, jmesh))

    def pipe(c):
        return vt.limiter(vt.boxblur(c, hradius=2, vradius=2), tv_range=True)

    got = run_sharded(pipe, tc, mesh=CPU8)
    _same(got, pipe(tc))
    assert_planes_match(got.planes, want.planes)


@pytest.mark.parametrize("tthr2,overlap", [(0, 1), (10, 2)])
def test_temporal_filter_sharded(jmesh, clip8, tthr2, overlap):
    """Checkmate reads +-1 frames (+-2 with tthr2): each shard takes that
    halo from its neighbours, where the JAX mesh lets XLA insert the reads."""
    jc, tc = clip8
    want = jax.jit(lambda c: j_checkmate(c, tthr2=tthr2))(j_shard_clip(jc, jmesh))
    got = run_sharded(lambda c: vt.checkmate(c, tthr2=tthr2), tc, mesh=CPU8, overlap=overlap)
    _same(got, vt.checkmate(tc, tthr2=tthr2))
    assert_planes_match(got.planes, want.planes)


def test_halo_is_needed(clip8):
    """Without the halo a temporal op's shard edges differ (so the halo is
    what makes the sharded run exact)."""
    _, tc = clip8
    got = run_sharded(lambda c: vt.checkmate(c, tthr2=10), tc, mesh=CPU8, overlap=0)
    assert not torch.equal(got.planes[0], vt.checkmate(tc, tthr2=10).planes[0])


def test_metric_reduction_sharded(jmesh, clip8):
    jc, tc = clip8
    mesh = frames_mesh(devices=["cpu"] * 4)
    for jop, top in ((lambda c: j_avg(c, planes=[0]), lambda c: vt.plane_average(c, planes=[0])),
                     (lambda c: j_minmax(c, planes=[0]), lambda c: vt.plane_minmax(c, planes=[0]))):
        want = jop(j_shard_clip(jc, jmesh))
        got = run_sharded(top, tc, mesh=mesh)
        _same(got, top(tc))
        for k, v in want.props.items():  # f64 sums: rtol 1e-12 (test_torch_plane_stats.py)
            np.testing.assert_allclose(got.props[k].numpy(), np.asarray(v), rtol=1e-12, atol=0)


def _xpsnr_pair(seed=11, n=8):
    rng = np.random.default_rng(seed)
    ref_p = tuple(rng.integers(0, 256, (n, 48 >> (p > 0), 64 >> (p > 0)), dtype=np.uint8)
                  for p in range(3))
    dist_p = tuple(np.clip(p.astype(np.int32) + rng.integers(-9, 9, p.shape), 0, 255)
                   .astype(np.uint8) for p in ref_p)
    return ref_p, dist_p


def test_xpsnr_sharded_matches_unsharded(jmesh):
    """XPSNR's temporal terms read frames n-1 and n-2 across the shards'
    edges, and its end-of-run average spans every frame."""
    ref_p, dist_p = _xpsnr_pair()
    (jr, tr), (jd, td) = _clips("YUV420P8", ref_p), _clips("YUV420P8", dist_p)
    want = j_xpsnr(j_shard_clip(jr, jmesh), j_shard_clip(jd, jmesh), fps=32)
    got = run_sharded(lambda r, d: vt.xpsnr(r, d, fps=32), tr, td, mesh=CPU8, overlap=2)
    _same(got, vt.xpsnr(tr, td, fps=32))
    for k in ("XPSNR_Y", "XPSNR_U", "XPSNR_V", "XPSNR_AVG"):
        np.testing.assert_allclose(got.props[k].numpy(), np.asarray(want.props[k]),
                                   rtol=1e-12, atol=0)
    np.testing.assert_array_equal(got.props["_XPSNR_WSSE"].numpy(),
                                  np.asarray(want.props["_XPSNR_WSSE"]))


def test_xpsnr_per_device_shards():
    """Kept per device: each span's clip, per-frame props trimmed to it, and
    the average over all frames on each."""
    ref_p, dist_p = _xpsnr_pair(12)
    (_, tr), (_, td) = _clips("YUV420P8", ref_p), _clips("YUV420P8", dist_p)
    mesh = frames_mesh(devices=["cpu"] * 4)
    parts = run_sharded(lambda r, d: vt.xpsnr(r, d, fps=32), tr, td, mesh=mesh, overlap=2,
                        per_device=True)
    want = vt.xpsnr(tr, td, fps=32)
    assert len(parts) == 4 and all(c.num_frames == 2 for c in parts)
    for p in range(3):
        assert torch.equal(torch.cat([c.planes[p] for c in parts]), want.planes[p])
    for k in ("XPSNR_Y", "_XPSNR_WSSE"):
        assert torch.equal(torch.cat([c.props[k] for c in parts]), want.props[k])
    for c in parts:
        assert torch.equal(c.props["XPSNR_AVG"], want.props["XPSNR_AVG"])


def test_ssimulacra2_sharded_matches_unsharded(jmesh):
    rng = np.random.default_rng(12)
    a_p = tuple(rng.random((8, 40, 48), np.float32) for _ in range(3))
    b_p = tuple(np.clip(p + rng.normal(0, 0.02, p.shape).astype(np.float32), 0, 1) for p in a_p)
    (ja, ta), (jb, tb) = _clips("RGBS", a_p), _clips("RGBS", b_p)
    want = np.asarray(j_ssim(j_shard_clip(ja, jmesh), j_shard_clip(jb, jmesh)).props["SSIMULACRA2"])
    got = run_sharded(vt.ssimulacra2, ta, tb, mesh=CPU8)
    _same(got, vt.ssimulacra2(ta, tb))
    np.testing.assert_allclose(got.props["SSIMULACRA2"].numpy(), want, rtol=1e-3, atol=1e-6)


def test_eedi3_sharded_matches_unsharded(jmesh):
    rng = np.random.default_rng(13)
    x = rng.random((8, 24, 32), dtype=np.float32)
    jc, tc = _clips("GRAYS", (x,))
    want = j_eedi3(j_shard_clip(jc, jmesh), field=1, dh=True, vcheck=2)
    got = run_sharded(lambda c: vt.eedi3(c, field=1, dh=True, vcheck=2), tc, mesh=CPU8)
    _same(got, vt.eedi3(tc, field=1, dh=True, vcheck=2))
    assert np.abs(got.planes[0].numpy() - np.asarray(want.planes[0])).max() < 2e-6


def test_frame_doubling_sharded():
    """EEDI3 field=2 doubles the frames: each shard's halo is trimmed in
    output frames."""
    rng = np.random.default_rng(14)
    _, tc = _clips("GRAYS", (rng.random((8, 24, 32), dtype=np.float32),))
    got = run_sharded(lambda c: vt.eedi3(c, field=2), tc,
                      mesh=frames_mesh(devices=["cpu"] * 4), overlap=1)
    _same(got, vt.eedi3(tc, field=2))


# ---------------------------------------------------------------------------
# the mesh itself, and the placement helpers
# ---------------------------------------------------------------------------

def test_frames_mesh_needs_visible_cards():
    """A truncated mesh must not let a multi-device run pass on fewer
    devices: without enough CUDA devices frames_mesh raises."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="visible"):
        frames_mesh(count + 1)
    if count == 0:
        with pytest.raises(RuntimeError, match="visible"):
            frames_mesh()


def test_frames_mesh_takes_devices_as_given():
    mesh = frames_mesh(devices=["cpu", torch.device("cpu"), "cpu"])
    assert mesh.devices == (torch.device("cpu"),) * 3 and mesh.size == 3
    assert mesh.axis_names == ("frames",)
    with pytest.raises(vt.VSZipError, match="no devices"):
        frames_mesh(devices=[])


def test_shard_and_replicate(clip8):
    _, tc = clip8
    tc = vt.plane_average(tc, planes=[0])
    shards = shard_clip(tc, frames_mesh(devices=["cpu"] * 4))
    assert [s.num_frames for s in shards] == [2] * 4
    for p in range(3):
        assert torch.equal(torch.cat([s.planes[p] for s in shards]), tc.planes[p])
    assert torch.equal(torch.cat([s.props["psmAvg"] for s in shards]), tc.props["psmAvg"])
    reps = replicate_clip(tc, frames_mesh(devices=["cpu"] * 2))
    assert len(reps) == 2 and all(torch.equal(r.planes[0], tc.planes[0]) for r in reps)
    with pytest.raises(vt.VSZipError, match="8 frames do not divide over a mesh of 3"):
        shard_clip(tc, frames_mesh(devices=["cpu"] * 3))


def test_run_sharded_errors(clip8):
    _, tc = clip8
    with pytest.raises(vt.VSZipError, match="do not divide"):
        run_sharded(vt.boxblur, tc, mesh=frames_mesh(devices=["cpu"] * 3))
    with pytest.raises(vt.VSZipError, match="frame counts differ"):
        run_sharded(lambda a, b: a, tc, tc.frame(0), mesh=CPU8)
    with pytest.raises(vt.VSZipError, match="overlap"):
        run_sharded(vt.boxblur, tc, mesh=CPU8, overlap=-1)
    with pytest.raises(vt.VSZipError, match="no clips"):
        run_sharded(vt.boxblur, mesh=CPU8)
    with pytest.raises(vt.VSZipError, match="run_sharded: op changed the chunk frame count"):
        run_sharded(lambda c: c.with_planes(tuple(p[:-1] for p in c.planes)), tc,
                    mesh=frames_mesh(devices=["cpu"] * 2))


def test_every_kernel_launch_enters_its_tensors_device(monkeypatch):
    """A mesh puts tensors on devices other than 0: every wrapper launches
    through an entry point declared with ``_build.kernel``, whose call enters
    the device it is given and passes that device's current stream, and each
    launch site gives it its tensor's device."""
    launches = 0
    for path in sorted((ROOT / "vszip_tpu_torch" / "kernels").glob("*.py")):
        tree = ast.parse(path.read_text())
        kernels = {t.id for node in tree.body if isinstance(node, ast.Assign)
                   and ast.unparse(node.value.func if isinstance(node.value, ast.Call)
                                   else node.value) == "_build.kernel"
                   for t in node.targets}
        # a local that holds one of two of them (Deband's m2 variants)
        kernels |= {t.id for node in ast.walk(tree) if isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.IfExp)
                    and {ast.unparse(node.value.body), ast.unparse(node.value.orelse)} <= kernels
                    for t in node.targets}
        devices = {t.id for node in ast.walk(tree) if isinstance(node, ast.Assign)
                   and ast.unparse(node.value).endswith(".device") for t in node.targets
                   if isinstance(t, ast.Name)}
        for node in ast.walk(tree):
            assert not (isinstance(node, ast.Attribute) and ast.unparse(node) in
                        ("torch.cuda.device", "_build.load")), f"{path.name}:{node.lineno}"
            if isinstance(node, ast.Call):
                f = ast.unparse(node.func)
                if f in kernels:
                    launches += 1
                    dev = ast.unparse(node.args[0])
                    assert dev.endswith(".device") or dev in devices, f"{path.name}:{node.lineno}"
    assert launches >= 17  # every launch site of B1-B18 (some wrappers share one)

    from vszip_tpu_torch import _build

    entered, calls = [], []

    class Device:
        def __init__(self, d):
            self.d = d

        def __enter__(self):
            entered.append(self.d)

        def __exit__(self, *exc):
            entered.append(None)

    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=1000 + d.index))
    k = _build.Kernel("boxblur", "vz_fake", (), None)
    _build.ENTRIES.remove(k)
    k.fn = lambda *a: calls.append((entered[-1], a)) or a[0]
    k(torch.device("cuda", 1), 0, 5)
    assert calls == [(torch.device("cuda", 1), (0, 5, 1001))] and entered[-1] is None
    with pytest.raises(RuntimeError, match="vz_fake failed with CUDA error 2"):
        k(torch.device("cuda", 0), 2)
    assert calls[-1] == (torch.device("cuda", 0), (2, 1000)) and entered[-1] is None


# ---------------------------------------------------------------------------
# process_stream over a mesh
# ---------------------------------------------------------------------------

def _src_planes(n=13, h=48, w=64, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, 65536, (n, h >> (p > 0), w >> (p > 0)), dtype=np.uint16)
                 for p in range(3))


def _stream(planes, fmt_name, op, **kw):
    """process_stream's sink output reassembled, and its props."""
    kept = {}
    props = vt.process_stream(vt.ArraySource(planes, vt.get_format(fmt_name)), op,
                              sink=lambda s, c: kept.__setitem__(s, c), donate=False, **kw)
    return [np.concatenate([kept[s].planes[p] for s in sorted(kept)])
            for p in range(len(planes))], props


def test_streamed_over_mesh_matches_resident():
    """13 frames in chunks of 8 over the 8-entry mesh: one chunk split over
    the entries, the 5-frame tail whole on the first."""
    planes = _src_planes()
    want = j_boxblur(vz.Clip.from_planes(planes, vz.get_format("YUV420P16")), hradius=3,
                     vradius=2)
    got, _ = _stream(planes, "YUV420P16", lambda c: vt.boxblur(c, hradius=3, vradius=2),
                     batch=8, mesh=CPU8)
    for g, w in zip(got, want.planes):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("mesh_size,batch,overlap,tthr2", [
    (2, 4, 1, 0), (2, 4, 2, 10), (3, 5, 2, 10), (4, 6, 1, 0)])
def test_streamed_temporal_over_mesh(mesh_size, batch, overlap, tthr2):
    planes = tuple((p >> 8).astype(np.uint8) for p in _src_planes(n=14, seed=1))
    mesh = frames_mesh(devices=["cpu"] * mesh_size)
    op = lambda c: vt.checkmate(c, tthr2=tthr2)  # noqa: E731
    meshed, _ = _stream(planes, "YUV420P8", op, batch=batch, overlap=overlap, mesh=mesh)
    plain, _ = _stream(planes, "YUV420P8", op, batch=batch, overlap=overlap, device="cpu")
    want = j_checkmate(vz.Clip.from_planes(planes, vz.get_format("YUV420P8")), tthr2=tthr2)
    for m, p, w in zip(meshed, plain, want.planes):
        np.testing.assert_array_equal(m, p)
        np.testing.assert_array_equal(m, np.asarray(w))


def test_streamed_xpsnr_over_mesh():
    """XPSNR through the stream with each frame's reference beside it (a
    2W-wide YUV420 frame: reference left, distorted right), so any span of
    a chunk carries its own reference; the average spans every frame."""
    ref_p, dist_p = _xpsnr_pair(15, n=14)
    both = tuple(np.concatenate([r, d], axis=2) for r, d in zip(ref_p, dist_p))

    def op(c):
        halves = [tuple(p[..., i * p.shape[2] // 2:(i + 1) * p.shape[2] // 2].contiguous()
                        for p in c.planes) for i in (0, 1)]
        return vt.xpsnr(*(vt.Clip(h, c.format, {}) for h in halves), fps=24)

    mesh = frames_mesh(devices=["cpu"] * 2)
    _, meshed = _stream(both, "YUV420P8", op, batch=4, overlap=2, mesh=mesh)
    _, plain = _stream(both, "YUV420P8", op, batch=4, overlap=2, device="cpu")
    (jr, tr), (jd, td) = _clips("YUV420P8", ref_p), _clips("YUV420P8", dist_p)
    own = vt.xpsnr(tr, td, fps=24)
    want = j_xpsnr(jr, jd, fps=24)
    assert set(meshed) == set(plain) == {"XPSNR_Y", "XPSNR_U", "XPSNR_V", "XPSNR_AVG"}
    for k in meshed:
        np.testing.assert_array_equal(meshed[k], plain[k])
        np.testing.assert_array_equal(meshed[k], own.props[k].numpy())
        np.testing.assert_allclose(meshed[k], np.asarray(want.props[k]), rtol=1e-12)


def test_streamed_props_and_frame_doubling_over_mesh():
    planes = _src_planes(n=12, seed=2)
    mesh = frames_mesh(devices=["cpu"] * 4)
    _, meshed = _stream(planes, "YUV420P16", lambda c: vt.plane_average(c, planes=[0, 1, 2]),
                        batch=8, mesh=mesh)
    want = j_avg(vz.Clip.from_planes(planes, vz.get_format("YUV420P16")), planes=[0, 1, 2])
    plain = vt.plane_average(vt.Clip.from_planes(planes, vt.get_format("YUV420P16"), device="cpu"),
                             planes=[0, 1, 2])
    np.testing.assert_array_equal(meshed["psmAvg"], plain.props["psmAvg"].numpy())
    np.testing.assert_allclose(meshed["psmAvg"], np.asarray(want.props["psmAvg"]), rtol=1e-12)
    x = np.random.default_rng(3).random((8, 24, 32), dtype=np.float32)
    got, _ = _stream((x,), "GRAYS", lambda c: vt.eedi3(c, field=2), batch=4, mesh=mesh)
    np.testing.assert_array_equal(
        got[0], vt.eedi3(vt.Clip.from_planes((x,), vt.get_format("GRAYS"), device="cpu"),
                         field=2).planes[0].numpy())


def test_process_stream_mesh_errors():
    src = vt.ArraySource(_src_planes(n=4), vt.get_format("YUV420P16"))
    with pytest.raises(vt.VSZipError, match="pass device or mesh, not both"):
        vt.process_stream(src, lambda c: c, mesh=CPU8, device="cpu")
    mixed = frames_mesh(devices=["cpu", "meta"])
    with pytest.raises(vt.VSZipError, match="all CUDA devices or all the CPU"):
        vt.process_stream(src, lambda c: c, mesh=mixed)
