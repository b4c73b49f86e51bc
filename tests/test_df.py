"""Double-float (f32x2) arithmetic: exactness and f64-equivalence under jit.

The df tier exists so the gauss-family parity gate can run at ~f64 precision
on hardware without fast float64 (ops/df.py). These
tests pin down the two properties everything rests on:

1. the error-free transforms (TwoSum/TwoProd) are EXACT for f32 inputs, and
   survive jit (XLA must not reassociate them away);
2. compound df operations agree with float64 to ~2^-45 relative — far below
   the 2^-24 single-float rounding that seeds the chaotic trajectory
   divergence diagnosed in PARITY.md.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from overiva_jax.ops import df



def jitg(f):
    """jit f with the df fma_guard installed (one = runtime argument)."""
    import functools

    @jax.jit
    def g(one, *args):
        with df.fma_guard(one):
            return f(*args)

    return functools.partial(g, np.float32(1.0))


def df_from_f64(x):
    """float64 array -> df-of-f32 pair representing it to ~2^-48."""
    hi = np.asarray(x, np.float32)
    lo = np.asarray(x - hi.astype(np.float64), np.float32)
    return jnp.asarray(hi), jnp.asarray(lo)


def df_to_f64(x):
    return np.asarray(x[0], np.float64) + np.asarray(x[1], np.float64)


@pytest.fixture
def vals(rng):
    # mixed magnitudes, exercised over several decades
    a = rng.standard_normal(4096).astype(np.float64)
    a *= 10.0 ** rng.integers(-6, 7, size=a.size)
    return a


def test_two_sum_exact_under_jit(vals, rng):
    a = vals.astype(np.float32)
    b = rng.permutation(vals).astype(np.float32)
    s, e = jitg(df.two_sum)(jnp.asarray(a), jnp.asarray(b))
    got = np.asarray(s, np.float64) + np.asarray(e, np.float64)
    want = a.astype(np.float64) + b.astype(np.float64)
    np.testing.assert_array_equal(got, want)


def test_two_prod_exact_under_jit(vals, rng):
    a = vals.astype(np.float32)
    b = rng.permutation(vals).astype(np.float32)
    p, e = jitg(df.two_prod)(jnp.asarray(a), jnp.asarray(b))
    # f32*f32 is exact in f64 (24+24 < 53 mantissa bits)
    got = np.asarray(p, np.float64) + np.asarray(e, np.float64)
    want = a.astype(np.float64) * b.astype(np.float64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div"])
def test_df_binary_vs_f64(vals, rng, op):
    b64 = rng.permutation(vals)
    if op == "div":
        b64 = np.where(np.abs(b64) < 1e-3, 1.0, b64)
    x, y = df_from_f64(vals), df_from_f64(b64)
    got = df_to_f64(jitg(getattr(df, op))(x, y))
    want = getattr(np, {"add": "add", "sub": "subtract", "mul": "multiply",
                        "div": "divide"}[op])(df_to_f64(x), df_to_f64(y))
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-300)
    assert rel.max() < 2.0**-45


def test_df_sqrt_recip_vs_f64(vals):
    a = np.abs(vals) + 1e-12
    x = df_from_f64(a)
    got = df_to_f64(jitg(df.sqrt)(x))
    rel = np.abs(got - np.sqrt(df_to_f64(x))) / np.sqrt(df_to_f64(x))
    assert rel.max() < 2.0**-45
    got = df_to_f64(jitg(df.recip)(x))
    rel = np.abs(got - 1.0 / df_to_f64(x)) * df_to_f64(x)
    assert rel.max() < 2.0**-45
    # sqrt(0) == 0, no NaN
    z = df.sqrt(df.from_float(jnp.zeros(3, jnp.float32)))
    assert np.all(df_to_f64(z) == 0.0)


def test_df_sum_tree_vs_f64(rng):
    # ill-conditioned sum: large cancellation, f32 loses ~all digits
    a = rng.standard_normal(1000)
    a64 = np.concatenate([a * 1e8, -a * 1e8, a])
    x = df_from_f64(a64)
    got = df_to_f64(jitg(lambda v: df.sum_tree(v, 0))(x))
    want = np.sum(df_to_f64(x))
    assert abs(got - want) < 2.0**-40 * np.sum(np.abs(a64))


def test_df_max_tree_matches_f64(rng):
    a64 = rng.standard_normal((37, 5)) * 10.0 ** rng.integers(-3, 4, (37, 5))
    x = df_from_f64(a64)
    got = df_to_f64(jitg(lambda v: df.max_tree(v, 0))(x))
    np.testing.assert_array_equal(got, np.max(df_to_f64(x).reshape(37, 5), 0))


def test_df_const():
    hi, lo = df.const(1e-3)
    got = np.float64(np.asarray(hi)) + np.float64(np.asarray(lo))
    assert abs(got - 1e-3) < 1e-3 * 2.0**-45
    assert np.asarray(hi).dtype == np.float32


def test_df_complex_mul_div_vs_c128(rng):
    a64 = rng.standard_normal(512) + 1j * rng.standard_normal(512)
    b64 = rng.standard_normal(512) + 1j * rng.standard_normal(512)
    za = (df_from_f64(a64.real), df_from_f64(a64.imag))
    zb = (df_from_f64(b64.real), df_from_f64(b64.imag))

    def c128(z):
        return df_to_f64(z[0]) + 1j * df_to_f64(z[1])

    got = c128(jitg(df.cmul)(za, zb))
    want = c128(za) * c128(zb)
    assert np.abs(got - want).max() / np.abs(want).max() < 2.0**-44
    got = c128(jitg(df.cdiv)(za, zb))
    want = c128(za) / c128(zb)
    assert np.abs(got - want).max() / np.abs(want).max() < 2.0**-44
    got = df_to_f64(jitg(df.cabs2)(za))
    rel = np.abs(got - np.abs(c128(za)) ** 2) / np.abs(c128(za)) ** 2
    assert rel.max() < 2.0**-44


def test_df_cprod_pure(rng):
    # product of two PURE f32 complex numbers: cross terms exact, the
    # combining adds df-rounded -> agree with f64 to ~2^-45 ABSOLUTE in
    # units of the product magnitude (the real part may fully cancel)
    ar, ai = [rng.standard_normal(256).astype(np.float32) for _ in range(2)]
    br, bi = [rng.standard_normal(256).astype(np.float32) for _ in range(2)]
    re, im = jitg(df.cprod_pure)(
        jnp.asarray(ar), jnp.asarray(ai), jnp.asarray(br), jnp.asarray(bi)
    )
    a = ar.astype(np.float64) + 1j * ai.astype(np.float64)
    b = br.astype(np.float64) + 1j * bi.astype(np.float64)
    scale = np.abs(a * b)
    assert (np.abs(df_to_f64(re) - (a * b).real) / scale).max() < 2.0**-45
    assert (np.abs(df_to_f64(im) - (a * b).imag) / scale).max() < 2.0**-45


def test_two_sum_of_raw_products_exact(rng):
    # Regression: the measured XLA miscompilation was two_sum(a*b, -(c*d))
    # inside one jitted graph — LLVM FMA-contracted the rematerialized
    # products so the EFT lost its error term on EVERY element. The
    # fma_guard's runtime-one pre-rounding must keep this exact.
    a, b, c, d = [rng.standard_normal(4096).astype(np.float32)
                  for _ in range(4)]
    s, e = jitg(lambda a, b, c, d: df.two_sum(a * b, -(c * d)))(
        *map(jnp.asarray, (a, b, c, d))
    )
    p32 = (a * b).astype(np.float32).astype(np.float64)
    q32 = (c * d).astype(np.float32).astype(np.float64)
    got = np.asarray(s, np.float64) + np.asarray(e, np.float64)
    np.testing.assert_array_equal(got, p32 - q32)


def test_df_pytree_through_scan():
    # df pairs must flow through lax.scan carries unchanged
    x = df_from_f64(np.float64(0.1))

    def body(c, _):
        return df.add(c, x), None

    out, _ = jitg(
        lambda v: jax.lax.scan(body, v, None, length=1000)
    )(df.from_float(jnp.float32(0.0)))
    assert abs(df_to_f64(out) - 1000 * df_to_f64(x)) < 1e-9
