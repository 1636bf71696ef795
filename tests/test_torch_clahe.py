"""vszip_tpu_torch.clahe held against vszip_tpu.clahe on seeded clips (8 and
16 bit, gray and 4:2:0, tiles that divide the plane and tiles that do not,
limits 1/7/40, odd plane sizes), B7's plain version against the Pallas
kernel in interpret mode and the literal NumPy oracle, and every
validation message.  On the CPU the port's 8-bit path runs B7's plain
version, so the op-level cases also check B7's function.

Tolerance: bit-exact everywhere (integer planes; the blend rounds each f32
step in both packages).
"""

import importlib

import numpy as np
import pytest

import vszip_tpu as vz
import vszip_tpu_torch as vt
from oracle.clahe_ref import clahe_ref
from test_torch_core import assert_planes_match, both_clips, make_planes, same_error
from vszip_tpu_torch.kernels import clahe as kc

tclahe = importlib.import_module("vszip_tpu_torch.ops.clahe")

ARGS = ({}, {"tiles": 1, "limit": 1}, {"tiles": [4, 2], "limit": 40},
        {"tiles": 7, "limit": 7})


@pytest.mark.parametrize("args", ARGS, ids=str)
@pytest.mark.parametrize("fmt", ["GRAY8", "YUV420P8", "GRAY16", "YUV420P16"])
def test_clahe_matches_jax(fmt, args):
    rng = np.random.default_rng([ARGS.index(args), len(fmt)])
    cj, ct = both_clips(fmt, make_planes(fmt, rng, 2, 58, 98))
    got = vt.clahe(ct, **args)
    want = vz.clahe(cj, **args)
    assert got.format == ct.format and got.props["_ColorRange"] == 0
    assert all(p.device.type == "cpu" for p in got.planes)
    assert_planes_match(got.planes, want.planes)


@pytest.mark.parametrize("fmt,h,w,args", [("GRAY8", 57, 95, {"tiles": [3, 5]}),
                                          ("GRAY16", 37, 53, {"tiles": 4, "limit": 40}),
                                          ("GRAY8", 5, 3, {"tiles": [3, 5], "limit": 1})],
                         ids=str)
def test_clahe_odd_sizes_match_jax(fmt, h, w, args):
    cj, ct = both_clips(fmt, make_planes(fmt, np.random.default_rng(h), 2, h, w))
    assert_planes_match(vt.clahe(ct, **args).planes, vz.clahe(cj, **args).planes)


@pytest.fixture
def interp(monkeypatch):
    import jax.experimental.pallas as plmod

    orig = plmod.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    def patch(mod):
        monkeypatch.setattr(mod.pl, "pallas_call", interp_call)

    return patch


def _table_inputs(n, h, w, tiles_x, tiles_y, seed):
    """A plane and the op's own B7 inputs for it, as NumPy f32 fractions."""
    import torch

    x = np.random.default_rng(seed).integers(0, 256, (n, h, w), dtype=np.uint8)
    lut = tclahe._luts(torch.from_numpy(x), 7, tiles_x, tiles_y, 8)
    tab, ya, xa, tile_h, tile_w = tclahe._lookup_inputs(lut, h, w, tiles_x, tiles_y)
    return x, tab, ya.numpy(), xa.numpy(), tile_h, tile_w


@pytest.mark.parametrize("shape,tiles", [((2, 128, 256), (4, 4)), ((1, 61, 90), (3, 2))],
                         ids=str)
def test_clahe8_plain_matches_pallas_interpret(interp, shape, tiles):
    import jax.numpy as jnp
    import torch

    from vszip_tpu.kernels import clahe_pallas as kp

    interp(kp)
    x, tab, ya, xa, tile_h, tile_w = _table_inputs(*shape, *tiles, seed=sum(shape))
    n, h, w = shape
    thh, twh = tile_h // 2, tile_w // 2
    hp, wp = ya.size, xa.size
    xp2 = np.pad(x, ((0, 0), (thh, hp - thh - h), (twh, wp - twh - w)))
    want = np.asarray(kp.clahe8_lookup_pallas(jnp.asarray(xp2), jnp.asarray(tab.numpy()),
                                              jnp.asarray(ya), jnp.asarray(xa),
                                              tile_h, tile_w))[:, thh:thh + h, twh:twh + w]
    got = kc.clahe8_lookup(torch.from_numpy(x), tab, torch.from_numpy(ya),
                           torch.from_numpy(xa), tile_h, tile_w).numpy()
    # The interpreted kernel runs its blend through XLA:CPU, which contracts
    # t1*oya + t2*ya into an FMA; that rounds the other way exactly where the
    # strict f32 result (the reference's, and the JAX op's CPU path) is a .5
    # tie.  Everywhere else the two agree bit for bit.
    py = np.arange(h) + thh
    px = np.arange(w) + twh
    word = np.take_along_axis(
        tab.numpy().reshape(n, -1),
        ((py[:, None] // tile_h * (wp // tile_w) + px[None, :] // tile_w) * 256
         + x.astype(np.int64)).reshape(n, -1), 1).reshape(n, h, w)
    l0, l1, l2, l3 = (((word >> s) & 255).astype(np.float32) for s in (0, 8, 16, 24))
    fy = ya.reshape(-1)[py][:, None]
    fx = xa.reshape(-1)[px][None, :]
    f32 = np.float32
    res = (f32(l0 * (f32(1) - fx)) + f32(l1 * fx)) * (f32(1) - fy) + (
        f32(l2 * (f32(1) - fx)) + f32(l3 * fx)) * fy
    tie = res == np.floor(res) + f32(0.5)
    assert (got == np.trunc(res + f32(0.5))).all()
    assert ((got == want) | (tie & (want.astype(np.int64) == got.astype(np.int64) - 1))).all()
    assert (got == want).mean() > 0.999


@pytest.mark.parametrize("fmt,limit,tiles", [("GRAY8", 4, 3), ("GRAY8", 7, [2, 3]),
                                             ("GRAY16", 2560, 4), ("GRAY16", 7, [3, 2])],
                         ids=str)
def test_clahe_matches_oracle(fmt, limit, tiles):
    img = make_planes(fmt, np.random.default_rng(limit), 1, 48, 64)[0]
    ct = vt.Clip.from_planes([img], vt.get_format(fmt), device="cpu")
    got = vt.clahe(ct, limit=limit, tiles=tiles).planes[0][0].numpy()
    tx, ty = (tiles, tiles) if isinstance(tiles, int) else tiles
    np.testing.assert_array_equal(got, clahe_ref(img[0], limit, tx, ty))


def test_clahe_errors():
    planes8 = make_planes("GRAY8", np.random.default_rng(0), 1, 16, 24)
    cj, ct = both_clips("GRAY8", planes8)
    fj, ft = both_clips("GRAYS", make_planes("GRAYS", np.random.default_rng(0), 1, 16, 24))
    yj, yt = both_clips("YUV420P8", make_planes("YUV420P8", np.random.default_rng(0), 1, 16, 24))
    msgs = [
        same_error(lambda: vz.clahe(fj), lambda: vt.clahe(ft)),
        same_error(lambda: vz.clahe(cj, tiles=[1, 2, 3]), lambda: vt.clahe(ct, tiles=[1, 2, 3])),
        same_error(lambda: vz.clahe(cj, tiles=[]), lambda: vt.clahe(ct, tiles=[])),
        same_error(lambda: vz.clahe(cj, tiles=[2, 0]), lambda: vt.clahe(ct, tiles=[2, 0])),
        same_error(lambda: vz.clahe(yj, tiles=[13, 1]), lambda: vt.clahe(yt, tiles=[13, 1])),
        same_error(lambda: vz.clahe(cj, limit=2**40), lambda: vt.clahe(ct, limit=2**40)),
    ]
    assert [m.split(":")[0].strip() for m in msgs] == ["CLAHE"] * 6
    assert "tiles must not exceed" in msgs[4] and "limit too large" in msgs[5]
