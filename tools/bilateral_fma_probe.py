"""How far XLA:CPU's jit and the three ``exp`` implementations move
Bilateral's f32 arithmetic, and how many outputs of the PyTorch port differ
from the JAX package's jitted and strict evaluations.

Run from the checkout root (CPU only; imports both packages):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tools/bilateral_fma_probe.py

Prints, for 2^20 random cases each:
- whether the jitted window sum ``wsum + swei*(((r0+r1)+r2)+r3)`` differs
  from separate f32 rounding, and how often it equals the FMA form;
- how often the jitted float index ``trunc(min(1, d)*65535 + 0.5)`` differs
  from the strict one (a different index moves the weight a whole LUT step);
- the same for the IIR step ``((b*v + b1*o1) + b2*o2) + b3*o3``;
- how often ``jnp.exp`` (jitted and op by op) and ``torch.exp`` differ from
  the correctly rounded f32 ``exp`` (NumPy f64, rounded once) on the range
  weight's arguments;
then, per format and algorithm, on seeded 2x56x96 planes, how many outputs of
the jitted package differ from its ``jax.disable_jit()`` evaluation and how
many of the port's differ from each.  Not a test: the numbers depend on the
XLA and torch versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

f32 = np.float32


def fma(a, b, c):
    """a*b + c rounded once to f32 (the f64 product of two f32 is exact)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(f32)


def main():
    rng = np.random.default_rng(0)
    n = 1 << 20
    wsum = (rng.random(n, dtype=f32) * 3).astype(f32)
    r = [rng.random(n, dtype=f32) for _ in range(4)]
    swei = f32(0.60653067)
    jit = np.asarray(jax.jit(lambda w, a, b, c, d: w + swei * (a + b + c + d))(wsum, *r))
    rsum = ((r[0] + r[1]) + r[2]) + r[3]
    strict = wsum + swei * rsum
    print(f"window sum: jitted != strict in {np.mean(jit != strict):.2%} of {n}; "
          f"jitted == fma(swei, rsum, wsum) in {np.mean(jit == fma(np.full(n, swei), rsum, wsum)):.2%}")

    for dt in (np.float32, np.float16):
        d = rng.random(n, dtype=f32).astype(dt).astype(f32) * f32(0.02)
        jit = np.asarray(jax.jit(lambda d: jnp.trunc(
            jnp.minimum(f32(1), d) * f32(65535) + f32(0.5)).astype(jnp.int32))(d))
        strict = np.trunc(np.minimum(f32(1), d) * f32(65535) + f32(0.5)).astype(np.int32)
        print(f"float index ({np.dtype(dt).name} |d|): jitted != strict in "
              f"{int((jit != strict).sum())} of {n}")

    v, o1, o2, o3 = (rng.random(n, dtype=f32) for _ in range(4))
    b, b1, b2, b3 = f32(0.1858), f32(2.1342), f32(-1.6008), f32(0.3808)
    jit = np.asarray(jax.jit(lambda v, o1, o2, o3: b * v + b1 * o1 + b2 * o2 + b3 * o3)(
        v, o1, o2, o3))
    strict = ((b * v + b1 * o1) + b2 * o2) + b3 * o3
    print(f"IIR step: jitted != strict in {np.mean(jit != strict):.2%} of {n}")

    a = -(rng.random(n, dtype=f32) * f32(30)).astype(f32)
    exact = np.exp(a.astype(np.float64)).astype(f32)
    jexp = np.asarray(jax.jit(jnp.exp)(a))
    with jax.disable_jit():
        jexp_op = np.asarray(jnp.exp(a))
    texp = torch.exp(torch.from_numpy(a)).numpy()
    for name, e in (("jnp.exp jitted", jexp), ("jnp.exp op by op", jexp_op),
                    ("torch.exp (CPU)", texp)):
        print(f"{name}: != correctly rounded in {np.mean(e != exact):.2%}; "
              f"!= torch.exp in {np.mean(e != texp):.2%} of {n}")

    import vszip_tpu as vz
    import vszip_tpu_torch as vt
    from vszip_tpu.ops.bilateral import bilateral as jb

    cases = [("GRAY16", dict(sigmaS=2, sigmaR=2, algorithm=2)),
             ("GRAY16", dict(sigmaS=3, sigmaR=0.02, algorithm=2)),
             ("GRAYS", dict(sigmaS=2, sigmaR=2, algorithm=2)),
             ("GRAYH", dict(sigmaS=2, sigmaR=0.1, algorithm=2)),
             ("GRAY16", dict(sigmaS=2, sigmaR=0.1, algorithm=1)),
             ("GRAY16", dict(sigmaS=3, sigmaR=0.02, algorithm=1)),
             ("GRAYS", dict(sigmaS=2, sigmaR=0.1, algorithm=1)),
             ("GRAYH", dict(sigmaS=2, sigmaR=0.1, algorithm=1))]
    for fmt_name, args in cases:
        fmt = vz.get_format(fmt_name)
        prng = np.random.default_rng(1)
        if fmt.sample_type.name == "INTEGER":
            x = prng.integers(0, 1 << fmt.bits_per_sample, (2, 56, 96), dtype=fmt.storage_dtype)
        else:
            x = prng.random((2, 56, 96), dtype=f32).astype(fmt.storage_dtype)
        jc = vz.Clip.from_planes([x], fmt)
        jit = np.asarray(jb(jc, **args).planes[0])
        with jax.disable_jit():
            eager = np.asarray(jb(jc, **args).planes[0])
        port = vt.bilateral(vt.Clip.from_planes([x], vt.get_format(fmt_name), device="cpu"),
                            **args).planes[0].numpy()
        print(f"{fmt_name} {args}: jitted != disable_jit in {int((jit != eager).sum())}, "
              f"port != jitted in {int((port != jit).sum())}, port != disable_jit in "
              f"{int((port != eager).sum())} of {x.size} outputs")


if __name__ == "__main__":
    main()
