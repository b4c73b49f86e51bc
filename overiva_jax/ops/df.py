"""Double-float (f32x2) arithmetic — emulated float64 from float32.

The tier was built for an accelerator with no native float64; the one
parity gap left in round 3 was the gauss-model family's intrinsic complex64 floor (~0.11 dB
on the worst probe seed, PARITY.md). The round-4 diagnosis experiment
(recorded in PARITY.md) showed the floor is NOT a single amplifier stage:
promoting the activation chain, the IP normalizer, or the solves to true
f64 individually just re-rolls the chaotic trajectory, while promoting
*everything after the one-time complex64 input cast* reproduces the f64
oracle to 0.0000 dB. Hence this module: full double-float arithmetic so
the whole iteration runs at ~2^-48 relative precision in f32 arithmetic.

Representation: a df number is a tuple ``(hi, lo)`` of same-dtype float
arrays with ``hi = fl(hi + lo)`` (non-overlapping). A df complex number is
``(re, im)`` with each part a df real. Both are JAX pytrees, so they flow
through ``lax.fori_loop``/``scan`` carries unchanged.

The building blocks are the classical error-free transforms (Dekker 1971,
Knuth TAOCP v2): TwoSum, Split, TwoProd — each exact in IEEE round-to-
nearest arithmetic, which IEEE f32 hardware implements.

**FMA-contraction hazard (measured, load-bearing).** XLA's HLO stays
faithful, but the CPU backend's LLVM emitter contracts ``mul`` feeding
``add``/``sub`` into an FMA *inside fusions* — and fusions freely
rematerialize producers, so a product consumed twice can take its exact
(unrounded) value in one consumer and its rounded value in another. That
silently voids every EFT identity (measured: two_sum(a*b, -(c*d)) loses
its error term on all elements; ``lax.optimization_barrier`` is stripped
by the CPU pipeline and does not help; no XLA flag gates it). The defense:
every EFT primitive pre-rounds its raw-product operands by multiplying
with a RUNTIME-OPAQUE 1.0 — contraction of ``fmul(x, one)`` into an add
computes ``round(x*1 + c) == round(x + c)``, the uncontracted semantics,
and LLVM cannot fold ``x*one`` because ``one`` is a traced argument, not a
constant. Callers that jit df code over raw products MUST install it:

    one = np.float32(1.0)          # pass as a jit ARGUMENT
    with df.fma_guard(one):        # inside the traced function
        ... df ops ...

``tests/test_df.py`` asserts exactness under jit on whatever backend runs
the suite; ``chip_smoke.py``'s df phase checks that the guard holds under
the GPU's LLVM backend too.

No counterpart exists in the reference repo (it has float64 natively);
this is infrastructure for the 0.1 dB parity contract on hardware whose
float64 is absent or slow.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp


__all__ = [
    "fma_guard", "two_sum", "split", "two_prod",
    "const", "from_float", "to_float", "add", "sub", "neg", "mul", "mul_f",
    "div", "recip", "sqrt", "max_", "where", "sum_tree", "max_tree",
    "cnum", "cfrom", "cto", "cadd", "csub", "cneg", "cconj", "cmul",
    "cmul_pure", "cprod_pure", "cscale", "cdiv", "cabs2", "cwhere",
    "cmat_from", "cmat_to",
]


# ------------------------------------------------------ error-free kernels

_ONE = None  # traced runtime 1.0 installed by fma_guard (see module docstring)


class fma_guard:
    """Context manager installing a runtime-opaque 1.0 for EFT pre-rounding.

    ``one`` must be a TRACED value (an argument of the enclosing jit), not
    a Python/NumPy constant baked into the graph — a constant would be
    folded and the protection lost. Reentrant; restores the previous guard
    on exit."""

    def __init__(self, one):
        self.one = one

    def __enter__(self):
        global _ONE
        self._prev = _ONE
        _ONE = self.one
        return self

    def __exit__(self, *exc):
        global _ONE
        _ONE = self._prev
        return False


def _rnd(x):
    """Pin x to its IEEE-rounded value for ALL consumers (no-op without
    an active fma_guard)."""
    return x if _ONE is None else x * _ONE


def two_sum(a, b):
    """s + err == a + b exactly (Knuth).

    Operands are pre-rounded via the fma_guard so an operand like
    ``b = -(c*d)`` cannot be FMA-contracted into ``s = a + b`` with its
    exact (unrounded) product — see the module docstring."""
    a, b = _rnd(a), _rnd(b)
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _quick_two_sum(a, b):
    """Requires |a| >= |b| (or a == 0)."""
    a, b = _rnd(a), _rnd(b)
    s = a + b
    return s, b - (s - a)


def _split_const(dtype):
    # 2^ceil(p/2) + 1 for p mantissa bits: f32 -> 4097, f64 -> 2^27+1
    return 4097.0 if jnp.dtype(dtype) == jnp.float32 else 134217729.0


def split(a):
    """a == hi + lo exactly, hi/lo each with ~p/2 mantissa bits (Dekker).

    The input and the Veltkamp product are pre-rounded — ``c - a`` and
    ``a - hi`` must consume ROUNDED values, never an FMA-contracted exact
    product (see module docstring)."""
    a = _rnd(jnp.asarray(a))
    c = _rnd(a * _split_const(a.dtype))
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """p + err == a * b exactly (Dekker, no FMA required).

    Inputs and ``p`` are pre-rounded (module docstring). The partial
    products ``ah*bh`` etc. are exempt: split halves carry <= 12 mantissa
    bits, so each partial product is exactly representable in f32 and an
    FMA contraction of it is value-identical."""
    a, b = _rnd(a), _rnd(b)
    p = _rnd(a * b)
    ah, al = split(a)
    bh, bl = split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


# ------------------------------------------------------------ df real ops

def const(x, dtype=jnp.float32):
    """A float64 Python constant as a df pair: hi = fl(x), lo = fl(x - hi).

    Represents the f64 value of reference constants (1/T, eps floors, ...)
    to ~2^-48 instead of f32's 2^-24 — constant rounding would otherwise
    seed the same chaotic trajectory divergence the df path exists to kill.
    """
    hi = np.asarray(x, dtype)
    lo = np.asarray(np.asarray(x, np.float64) - np.float64(hi), dtype)
    return jnp.asarray(hi), jnp.asarray(lo)


def from_float(a):
    a = jnp.asarray(a)
    return a, jnp.zeros_like(a)


def to_float(x):
    return x[0] + x[1]


def add(x, y):
    """Accurate df add (two TwoSums): relative error O(u^2) even under
    cancellation — the 'sloppy' one-TwoSum variant loses all relative
    accuracy when x + y cancels, which the IVA epoch hits constantly
    (Hermitian products minus their conjugates, normalizer terms)."""
    s, e = two_sum(x[0], y[0])
    t, f = two_sum(x[1], y[1])
    e = e + t
    s, e = _quick_two_sum(s, e)
    e = e + f
    return _quick_two_sum(s, e)


def neg(x):
    return -x[0], -x[1]


def sub(x, y):
    return add(x, neg(y))


def mul(x, y):
    p, e = two_prod(x[0], y[0])
    e = e + (x[0] * y[1] + x[1] * y[0])
    return _quick_two_sum(p, e)


def mul_f(x, b):
    """df * plain float (exact-operand fast path)."""
    p, e = two_prod(x[0], b)
    e = e + x[1] * b
    return _quick_two_sum(p, e)


def div(x, y):
    """Long division: three quotient terms -> full df accuracy."""
    q1 = x[0] / y[0]
    r = sub(x, mul_f(y, q1))
    q2 = r[0] / y[0]
    r = sub(r, mul_f(y, q2))
    q3 = r[0] / y[0]
    q = _quick_two_sum(q1, q2)
    return add(q, from_float(q3))


def recip(y):
    one = jnp.ones_like(y[0])
    return div((one, jnp.zeros_like(one)), y)


def sqrt(x):
    """Karp's method: f32 seed + one df correction. x >= 0 (else NaN,
    matching float64 semantics); exact 0 -> 0."""
    s = jnp.sqrt(x[0])
    ok = x[0] > 0
    safe = jnp.where(ok, s, 1.0)
    p, e = two_prod(safe, safe)
    d = add(sub(x, (p, jnp.zeros_like(p))), (-e, jnp.zeros_like(e)))
    corr = d[0] / (2.0 * safe)
    hi, lo = _quick_two_sum(safe, corr)
    zero = jnp.zeros_like(hi)
    return jnp.where(ok, hi, jnp.sqrt(x[0])), jnp.where(ok, lo, zero)


def _gt(x, y):
    return (x[0] > y[0]) | ((x[0] == y[0]) & (x[1] > y[1]))


def where(mask, x, y):
    return jnp.where(mask, x[0], y[0]), jnp.where(mask, x[1], y[1])


def max_(x, y):
    return where(_gt(x, y), x, y)


def sum_tree(x, axis: int):
    """Reduce a df array along ``axis`` by pairwise df adds (error O(u^2)
    per level, ~log2(n) levels). Pads with zeros to the next power of two."""
    hi, lo = x
    n = hi.shape[axis]
    hi = jnp.moveaxis(hi, axis, 0)
    lo = jnp.moveaxis(lo, axis, 0)
    m = 1
    while m < n:
        m *= 2
    if m != n:
        pad = [(0, m - n)] + [(0, 0)] * (hi.ndim - 1)
        hi = jnp.pad(hi, pad)
        lo = jnp.pad(lo, pad)
    while hi.shape[0] > 1:
        half = hi.shape[0] // 2
        (hi, lo) = add((hi[:half], lo[:half]), (hi[half:], lo[half:]))
    return hi[0], lo[0]


def max_tree(x, axis: int):
    """Reduce a df array along ``axis`` with the df max (pads with -inf)."""
    hi, lo = x
    n = hi.shape[axis]
    hi = jnp.moveaxis(hi, axis, 0)
    lo = jnp.moveaxis(lo, axis, 0)
    m = 1
    while m < n:
        m *= 2
    if m != n:
        pad = [(0, m - n)] + [(0, 0)] * (hi.ndim - 1)
        hi = jnp.pad(hi, pad, constant_values=-jnp.inf)
        lo = jnp.pad(lo, pad)
    while hi.shape[0] > 1:
        half = hi.shape[0] // 2
        (hi, lo) = max_((hi[:half], lo[:half]), (hi[half:], lo[half:]))
    return hi[0], lo[0]


# --------------------------------------------------------- df complex ops

def cnum(re, im):
    return re, im


def cfrom(z):
    """Plain complex array -> df complex (exact)."""
    return from_float(jnp.real(z)), from_float(jnp.imag(z))


def cto(z, dtype=None):
    """df complex -> plain complex array."""
    out = to_float(z[0]) + 1j * to_float(z[1])
    return out.astype(dtype) if dtype is not None else out


def cadd(a, b):
    return add(a[0], b[0]), add(a[1], b[1])


def csub(a, b):
    return sub(a[0], b[0]), sub(a[1], b[1])


def cneg(a):
    return neg(a[0]), neg(a[1])


def cconj(a):
    return a[0], neg(a[1])


def cmul(a, b):
    re = sub(mul(a[0], b[0]), mul(a[1], b[1]))
    im = add(mul(a[0], b[1]), mul(a[1], b[0]))
    return re, im


def cmul_pure(a, br, bi):
    """df complex * pure (single-float) complex given as (re, im) floats."""
    re = sub(mul_f(a[0], br), mul_f(a[1], bi))
    im = add(mul_f(a[0], bi), mul_f(a[1], br))
    return re, im


def cprod_pure(ar, ai, br, bi):
    """Product of two pure single-float complex numbers -> df complex.
    Each cross product (ar*br etc.) is EXACT via TwoProd; the combining
    adds are df-rounded (~2^-48 relative)."""
    re = add(two_prod(ar, br), _tneg(two_prod(ai, bi)))
    im = add(two_prod(ar, bi), two_prod(ai, br))
    return re, im


def _tneg(t):
    return -t[0], -t[1]


def cscale(a, s):
    """df complex * df real."""
    return mul(a[0], s), mul(a[1], s)


def cabs2(a):
    """|z|^2 as df real."""
    return add(mul(a[0], a[0]), mul(a[1], a[1]))


def cdiv(a, b):
    d = cabs2(b)
    num_re = add(mul(a[0], b[0]), mul(a[1], b[1]))
    num_im = sub(mul(a[1], b[0]), mul(a[0], b[1]))
    return div(num_re, d), div(num_im, d)


def cwhere(mask, a, b):
    return where(mask, a[0], b[0]), where(mask, a[1], b[1])


def cmat_from(Z):
    """Complex array -> df complex pytree (zeros lo planes)."""
    return cfrom(Z)


def cmat_to(Z, dtype):
    return cto(Z, dtype)
