"""The reference's VCL2 transcendentals in PyTorch (a port of
``vszip_tpu.ops.vcl``; the reference's src/vcl.zig, itself Agner Fog's
vectorclass vectormath_{exp,trig}.h).

``pow_`` is Deband m6/m7's soft-blend factor ``pow(product, 0.1)``,
``atan`` Deband m7's gradient angle and ``cbrt`` SSIMULACRA2's XYB
nonlinearity.  The polynomials keep the same coefficients, association
order and bit-level exponent handling, on int32 bit views of float32
tensors.  Every product and sum is its own torch op, rounded on its own:
eager torch does not contract ``a*b + c`` into FMA.  (The Zig kernels use
``@mulAdd``; XLA:CPU contracts some of the JAX package's products, so the
two ports agree within 2 ulp, not bit for bit.)  ``csrc/deband.cu`` runs
the same ``pow_`` with contraction off and equals this version on the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_F32 = torch.float32
_I32 = torch.int32
_SIGN = -(1 << 31)  # 0x80000000 as an int32


def _c(v) -> float:
    """A constant rounded to float32 once, as the JAX package's _F32(v)."""
    return float(np.float32(v))


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(_I32)


def _float(u: torch.Tensor) -> torch.Tensor:
    return u.view(_F32)


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    """``trunc(x ± 0.5)``, as the JAX package has it (ROADMAP §C: this
    double-rounds f32 values one ulp below n+0.5, unlike Zig's @round)."""
    return torch.trunc(x + torch.where(x >= 0, _c(0.5), _c(-0.5)))


def _copysign(mag: torch.Tensor, sign_src: torch.Tensor) -> torch.Tensor:
    return _float((_bits(mag) & 0x7FFFFFFF) | (_bits(sign_src) & _SIGN))


def _poly3(x, c0, c1, c2, c3):
    # vcl.zig polynomial_3: (c3*x + c2)*x2 + (c1*x + c0)
    x2 = x * x
    return (_c(c3) * x + _c(c2)) * x2 + (_c(c1) * x + _c(c0))


def _poly5(x, c0, c1, c2, c3, c4, c5):
    # vcl.zig polynomial_5: (c3*x+c2)*x2 + ((c5*x+c4)*x4 + (c1*x+c0))
    x2 = x * x
    x4 = x2 * x2
    return ((_c(c3) * x + _c(c2)) * x2
            + ((_c(c5) * x + _c(c4)) * x4 + (_c(c1) * x + _c(c0))))


def _poly8(x, c0, c1, c2, c3, c4, c5, c6, c7, c8):
    # vcl.zig polynomial_8 association order
    x2 = x * x
    x4 = x2 * x2
    x8 = x4 * x4
    hi = (_c(c7) * x + _c(c6)) * x2 + (_c(c5) * x + _c(c4))
    lo = ((_c(c3) * x + _c(c2)) * x2
          + ((_c(c1) * x + _c(c0)) + _c(c8) * x8))
    return hi * x4 + lo


def _fraction_2(a: torch.Tensor) -> torch.Tensor:
    """Mantissa with exponent forced to -1: bits -> (mant | 0x3F000000)."""
    return _float((_bits(a) & 0x007FFFFF) | 0x3F000000)


def _exponent_f(a: torch.Tensor) -> torch.Tensor:
    """Unbiased exponent as f32."""
    return (((_bits(a) >> 23) & 0xFF) - 127).to(_F32)


def atan(x: torch.Tensor) -> torch.Tensor:
    """VCL2 atan_f (src/vcl.zig:3-38): octant reduction around
    tan(pi/8)=sqrt2-1 / tan(3pi/8)=sqrt2+1, degree-3 odd polynomial in
    z^2, copysign restore."""
    t = x.abs()
    notsmal = t >= _c(math.sqrt(2.0) - 1.0)
    notbig = t <= _c(math.sqrt(2.0) + 1.0)

    zero = torch.zeros_like(t)
    s = torch.where(notbig, _c(math.pi * 0.25), _c(math.pi * 0.5)).to(_F32)
    s = torch.where(notsmal, s, zero)

    a = torch.where(notbig, t, zero)
    a = a + torch.where(notsmal, _c(-1.0), _c(0.0)).to(_F32)
    b = torch.where(notbig, _c(1.0), _c(0.0)).to(_F32)
    b = b + torch.where(notsmal, t, zero)

    z = a / b
    zz = z * z
    re = _poly3(zz, -3.33329491539e-1, 1.99777106478e-1,
                -1.38776856032e-1, 8.05374449538e-2)
    re = re * (zz * z) + z + s
    return _copysign(re, x)


def cbrt(x: torch.Tensor) -> torch.Tensor:
    """VCL2 cbrt_f (src/vcl.zig:40-81): exponent-hacked seed
    ``bitcast(0x54800000 - exp_bits*0x002AAAAA)``, 3 Newton iterations,
    one refined step, ``a^2 * x``; |x| <= 2^-126 underflows to 0."""
    one_third = _c(1.0 / 3.0)
    four_third = _c(4.0 / 3.0)
    xa = x.abs()
    xa3 = one_third * xa
    m1 = _bits(xa)  # sign bit clear, so the int32 view orders as uint32
    a = _float(0x54800000 - (m1 >> 23) * 0x002AAAAA)
    underflow = m1 <= 0x00800000
    for _ in range(3):
        a2 = a * a
        a = (four_third * a) - (xa3 * (a2 * a2))
    a2 = a * a
    a = a + (one_third * (a - (xa * (a2 * a2))))
    a = (a * a) * x
    return torch.where(underflow, torch.zeros_like(a), a)


def pow_(x0: torch.Tensor, y) -> torch.Tensor:
    """VCL2 pow_template_f (src/vcl.zig:85-180): log via degree-8
    polynomial on the mantissa with hi/lo ln2 split and error
    compensation, three-way exponent accumulation (e1+e2+e3), exp via
    degree-5 Taylor, exponent injected by wrapping bit arithmetic.
    Handles the x==+-0 cases like the reference (y>0 -> 0, y==0 -> 1,
    y<0 -> inf); negative non-zero x follows |x| (the reference's
    deband call sites only pass x in [0,1])."""
    y = torch.as_tensor(y, dtype=_F32, device=x0.device)

    x1 = x0.abs()
    x = _fraction_2(x1)
    blend = x > _c(0.7071067811865476)
    x = torch.where(blend, x, x + x)
    x = x - _c(1.0)

    x2 = x * x
    lg1 = _poly8(x, 3.3333331174e-1, -2.4999993993e-1, 2.0000714765e-1,
                 -1.6668057665e-1, 1.4249322787e-1, -1.2420140846e-1,
                 1.1676998740e-1, -1.1514610310e-1, 7.0376836292e-2)
    lg1 = lg1 * (x2 * x)

    ef = _exponent_f(x1)
    ef = torch.where(blend, ef + _c(1.0), ef)

    e1 = _round_half_away(ef * y)
    yr = ef * y - e1

    half = _c(0.5)
    lg = (half * (-x2) + x) + lg1
    x2err = (half * x) * x + half * (-x2)
    lgerr = half * x2 + (lg - x) - lg1

    log2e = _c(1.4426950408889634)
    ln2f_hi = _c(0.693359375)
    ln2f_lo = _c(-2.12194440e-4)
    ln2 = _c(0.6931471805599453)

    e2 = _round_half_away(lg * y * log2e)
    v = lg * y + (-e2) * ln2f_hi
    v = (-e2) * ln2f_lo + v

    correction = (lgerr + x2err) * y + (-yr) * ln2
    v = v - correction

    x = v
    e3 = _round_half_away(x * log2e)
    x = (-e3) * ln2 + x

    x2e = x * x
    z = _poly5(x, 1.0 / 2.0, 1.0 / 6.0, 1.0 / 24.0, 1.0 / 120.0,
               1.0 / 720.0, 1.0 / 5040.0)
    z = z * x2e + x + _c(1.0)

    ee = e1 + e2 + e3
    ei = _round_half_away(ee).to(torch.int64)
    # uint32 wrap-around of bits(z) + (ei << 23), in int64 then back
    zb = (_bits(z).to(torch.int64) + (ei << 23)) & 0xFFFFFFFF
    z = _float(torch.where(zb >= 1 << 31, zb - (1 << 32), zb).to(_I32))

    xzero = (_bits(x0.expand(z.shape).contiguous()) & 0x7F800000) == 0
    zero_case = torch.where(y < 0, torch.tensor(float("inf"), dtype=_F32, device=z.device),
                            torch.where(y == 0, _c(1.0), _c(0.0)).to(_F32))
    return torch.where(xzero, zero_case.expand(z.shape), z)
