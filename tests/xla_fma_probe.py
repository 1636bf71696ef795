"""How far XLA:CPU's jit departs from strict f32 on EEDI3's and
SSIMULACRA2's arithmetic.

Run from the checkout root:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/xla_fma_probe.py

Prints, for 2^20 random cases, how often the jitted cost expression
``alpha*s + beta_u + omab*v`` and the 4-tap ``0.5625*(a+b) - 0.0625*(c+d)``
differ from separate f32 rounding, and whether the cost equals
``fma(omab, v, fma(alpha, s, beta_u))``; then how many entries of
``vszip_tpu.ops.eedi3._costs_nonhp`` jitted differ from the same function
under ``jax.disable_jit()`` (B=2, L=9, W=120, mdis=6); then the same for
``vszip_tpu.ops.ssimulacra2._blur_1d`` (2x40x50 f32, axis 2), and which
association the jitted ``_downscale2`` computes: ``((a+b)+c)+d`` or the
``(a+b)+(c+d)`` of its docstring.  Not a test: the numbers depend on the
XLA version.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np

f32 = np.float32


def fma(a, b, c):
    """a*b + c rounded once to f32 (the f64 product of two f32 is exact)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(f32)


def main():
    rng = np.random.default_rng(0)
    n = 1 << 20
    s, v = (rng.random(n, dtype=f32) * 60).astype(f32), rng.random(n, dtype=f32)
    alpha, beta_u, omab = f32(0.2 / 3), f32(0.25 / 255 * 7), f32(0.55)
    cost = np.asarray(jax.jit(lambda s, v: alpha * s + beta_u + omab * v)(s, v))
    strict = (alpha * s + beta_u) + omab * v  # NumPy rounds each operation
    contracted = fma(np.full(n, omab), v, fma(np.full(n, alpha), s, np.full(n, beta_u)))
    print(f"cost: jitted != strict in {np.mean(cost != strict):.1%} of {n} cases; "
          f"jitted == fma(omab, v, fma(alpha, s, beta_u)) in {np.mean(cost == contracted):.4%}")

    a, b, c, d = (rng.random(n, dtype=f32) for _ in range(4))
    tap = np.asarray(jax.jit(lambda a, b, c, d: f32(0.5625) * (a + b) - f32(0.0625) * (c + d))(
        a, b, c, d))
    strict_tap = f32(0.5625) * (a + b) - f32(0.0625) * (c + d)
    print(f"4-tap: jitted != strict in {np.mean(tap != strict_tap):.1%} of {n} cases")

    E = importlib.import_module("vszip_tpu.ops.eedi3")
    rows = [jnp.asarray(rng.random((2, 9, 120), dtype=f32)) for _ in range(4)]
    padded = [E._pad_rows(r) for r in rows]
    args = (6, 2, float(alpha), float(f32(0.25 / 255)), float(omab))
    jitted = np.stack([np.asarray(c) for c in jax.jit(
        lambda *p: E._costs_nonhp(*p, *args))(*padded)])
    with jax.disable_jit():
        eager = np.stack([np.asarray(c) for c in E._costs_nonhp(*padded, *args)])
    print(f"_costs_nonhp: jitted != disable_jit in {int((jitted != eager).sum())} of "
          f"{jitted.size} entries")

    S = importlib.import_module("vszip_tpu.ops.ssimulacra2")
    x = jnp.asarray(rng.random((2, 40, 50), dtype=f32))
    jitted = np.asarray(jax.jit(S._blur_1d, static_argnums=1)(x, 2))
    with jax.disable_jit():
        eager = np.asarray(S._blur_1d(x, 2))
    print(f"ssimulacra2 _blur_1d: jitted != disable_jit in {int((jitted != eager).sum())} of "
          f"{jitted.size} outputs")
    down = np.asarray(jax.jit(S._downscale2)(x))
    xs = np.asarray(x)
    a, b, c, d = xs[:, 0::2, 0::2], xs[:, 0::2, 1::2], xs[:, 1::2, 0::2], xs[:, 1::2, 1::2]
    seq, pair = (((a + b) + c) + d) * f32(0.25), ((a + b) + (c + d)) * f32(0.25)
    print(f"ssimulacra2 _downscale2 jitted: == ((a+b)+c)+d in {np.mean(down == seq):.2%}, "
          f"== (a+b)+(c+d) in {np.mean(down == pair):.2%} of {down.size} outputs")


if __name__ == "__main__":
    main()
