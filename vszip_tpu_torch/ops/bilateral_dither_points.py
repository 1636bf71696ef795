"""Sub-sampling point-list generator for BilateralDither.

Reference: src/filters/bilateral_dither_subspl.zig (itself a port of
Dither_bilateral16's point generation).  Create-time host code: builds
NBR_POINT_LISTS lists of k window offsets per plane geometry — spiral arms
with random completion for small k, a void-and-cluster dither matrix scan
otherwise.  The RNGs replicate the originals exactly: a 1664525/1013904223
LCG (also used per-row at frame time) and libstdc++'s minstd_rand0 with its
uniform_int_distribution rejection scheme.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

NBR_POINT_LISTS = 23
MAX_SUBSPL_POINTS = 4096
SPIRAL_THRESHOLD = 32
VNC_KS = 9

M32 = 0xFFFFFFFF


def rnd_next(v: int) -> int:
    return (v * 1664525 + 1013904223) & M32


@lru_cache(maxsize=32)
def rnd_row_values(h: int) -> np.ndarray:
    """getRndAtStep(y) for y in [0, h): LCG advanced y+1 times from seed 1."""
    out = np.zeros(h, np.uint32)
    v = 1
    for y in range(h):
        v = rnd_next(v)
        out[y] = v
    return out


class MinStd0:
    def __init__(self, seed: int = 1):
        s = seed % 2147483647
        self.state = 1 if s == 0 else s

    def next(self) -> int:
        self.state = (self.state * 16807) % 2147483647
        return self.state

    def dist(self, n: int) -> int:
        urange = 2147483645
        scaling = urange // n
        past = n * scaling
        while True:
            ret = self.next() - 1
            if ret < past:
                return ret // scaling


def _round_int(x: float) -> int:
    """round-to-nearest-even of the f32 value (fstb::round_int)."""
    return int(np.rint(np.float32(x)))


def _vnc_kernel() -> np.ndarray:
    ker = np.zeros((VNC_KS, VNC_KS))
    kh = (VNC_KS - 1) // 2
    inv2s2 = 1.0 / (2.0 * 1.5 * 1.5)
    for j in range(kh + 1):
        for i in range(kh + 1):
            c = math.exp(-(i * i + j * j) * inv2s2)
            for sy in (j, -j):
                for sx in (i, -i):
                    ker[sy % VNC_KS, sx % VNC_KS] = c
    return ker


def _vnc_initial(size: int) -> np.ndarray:
    thr = 0.1
    m = np.zeros((size, size), np.uint16)
    err = np.zeros((size, size))
    dir_ = 1
    for _ in range(2):
        for y in range(size):
            xs = range(size - 1, -1, -1) if dir_ < 0 else range(size)
            for x in xs:
                e0 = err[y, x]
                err[y, x] = 0.0
                val = thr + e0
                q = _round_int(val)
                q = 0 if q < 0 else (1 if q > 1 else q)
                m[y, x] = q
                e = val - q
                err[y, (x + dir_) % size] += e * 0.5
                err[(y + 1) % size, (x - dir_) % size] += e * 0.25
                err[(y + 1) % size, x % size] += e * 0.25
            dir_ = -dir_
    return m


def _find_cluster(m: np.ndarray, kern: np.ndarray, color: int):
    size = m.shape[0]
    kh = (VNC_KS - 1) // 2
    best, bx, by = -1.0, 0, 0
    for y in range(size):
        for x in range(size):
            if m[y, x] != color:
                continue
            s = 0.0
            for j in range(-kh, kh + 1):
                for i in range(-kh, kh + 1):
                    if m[(y + j) % size, (x + i) % size] == color:
                        s += kern[j % VNC_KS, i % VNC_KS]
            if s > best:
                best, bx, by = s, x, y
    return bx, by


@lru_cache(maxsize=8)
def _vnc_matrix(size: int) -> np.ndarray:
    kern = _vnc_kernel()
    base = _vnc_initial(size)
    while True:
        cx, cy = _find_cluster(base, kern, 1)
        base[cy, cx] = 0
        vx, vy = _find_cluster(base, kern, 0)
        base[vy, vx] = 1
        if cx == vx and cy == vy:
            break
    vnc = np.zeros((size, size), np.int32)
    rank = int((base == 1).sum())
    mat = base.copy()
    while rank > 0:
        rank -= 1
        cx, cy = _find_cluster(mat, kern, 1)
        mat[cy, cx] = 0
        vnc[cy, cx] = rank
    rank = int((base == 1).sum())
    mat = base.copy()
    while rank < size * size:
        vx, vy = _find_cluster(mat, kern, 0)
        mat[vy, vx] = 1
        vnc[vy, vx] = rank
        rank += 1
    return vnc


@lru_cache(maxsize=32)
def generate(r_h: int, r_v: int, subspl: float):
    """Returns (points (NBR, k, 2 [dy, dx]) int32, k)."""
    base_area = (r_h * 2 - 1) * (r_v * 2 - 1)
    actual = subspl if subspl >= 1e-3 else float(r_h + r_v)
    k = min(max(_round_int(base_area / actual), 3), MAX_SUBSPL_POINTS)

    max_h = r_h * 2 - 1
    max_v = r_v * 2 - 1
    vnc_size = min(max((max(max_h, max_v) * 3) // 2, 16), 32)
    vnc_area = vnc_size * vnc_size
    vnc = _vnc_matrix(vnc_size) if k >= SPIRAL_THRESHOLD else None

    ms_a, ms_x, ms_y = MinStd0(1), MinStd0(1), MinStd0(1)
    rnd_val = 1
    pts = np.zeros((NBR_POINT_LISTS, k, 2), np.int32)

    for lc in range(NBR_POINT_LISTS):
        done = set()
        pts[lc, 0] = (0, 0)
        done.add((0, 0))
        cnt = 1
        if k < SPIRAL_THRESHOLD:
            angle_base = ms_a.dist(NBR_POINT_LISTS) * (
                math.pi * 0.5 / NBR_POINT_LISTS
            )
            arm_dir = 1 - (lc & 2)
            narm = 4
            npa = (k - 1) // narm
            amul = 2.0 * math.pi / narm * arm_dir
            for p in range(npa):
                posd = (p / npa) ** (3.0 / 5.0)
                for a in range(narm):
                    ang = angle_base + (posd * 2.0 + a) * amul
                    x = _round_int(math.cos(ang) * posd * (r_h - 1))
                    y = _round_int(math.sin(ang) * posd * (r_v - 1))
                    da = (x + r_h - 1) + (y + r_v - 1) * max_h
                    if 0 <= da < max_h * max_v and (x, y) not in done:
                        pts[lc, cnt] = (y, x)
                        done.add((x, y))
                        cnt += 1
            while cnt < k:
                rnd_val = rnd_next(rnd_val)
                x = int((rnd_val >> 8) % max_h) - (r_h - 1)
                rnd_val = rnd_next(rnd_val)
                y = int((rnd_val >> 8) % max_v) - (r_v - 1)
                if (x, y) not in done:
                    pts[lc, cnt] = (y, x)
                    done.add((x, y))
                    cnt += 1
        else:
            ofs_x = ms_x.dist(max_h)
            ofs_y = ms_y.dist(max_v)
            cur_lvl = 0
            trg_lvl = int(math.floor(vnc_area / actual))
            while cnt < k:
                for y in range(max_h):
                    if cnt >= k:
                        break
                    for x in range(max_v):
                        if cnt >= k:
                            break
                        v = int(vnc[(y + ofs_y) % vnc_size, (x + ofs_x) % vnc_size])
                        if cur_lvl <= v < trg_lvl:
                            px = x - (r_h - 1)
                            py = y - (r_v - 1)
                            if (px, py) not in done:
                                pts[lc, cnt] = (py, px)
                                done.add((px, py))
                                cnt += 1
                cur_lvl = trg_lvl
                trg_lvl += 1
    return pts, k
