"""Bin-minor ("planar") batched small linear algebra: shapes (m, n, F).

Layout rationale: the hot-loop tensors of the IVA family are huge stacks
of tiny matrices. In the natural F-major layout ``(F, m, n)`` the tiny
(m, n) dims are the minor (contiguous) ones; storing bins minor,
``(m, n, F)``, makes the F≈2049 batch axis contiguous, so every
elementwise pass over one (i, j) entry is a long unit-stride vector and the
small static indices live in the major dims. The layout was chosen on the
first accelerator the system ran on; whether it still pays on the GPU
against the F-major twins in ``ops/linalg.py`` is an open measurement.

All contractions here are broadcast-multiply + reduce over an explicit small
axis — never ``dot``/``einsum`` — so XLA keeps the layout instead of
normalizing to a batched GEMM (which would transpose back to F-major).

Same mask-pivoted Gauss-Jordan math as :mod:`overiva_jax.ops.linalg`
(reference behavior per SURVEY.md §2.3; pivot selection is identical, so the
two paths agree to f32 roundoff).
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "mat_h_fm",
    "matmul_fm",
    "matvec_fm",
    "vecmat_fm",
    "gauss_solve_fm",
    "clamp_pow2_fm",
    "quad_form_fm",
    "solve_vec_fm",
    "solve_mat_fm",
    "replace_row",
    "to_fminor",
    "to_fmajor",
]


def replace_row(A, k: int, row):
    """Static-index leading-axis row replacement via concat (scatter-free).

    ``.at[k].set`` on a loop-carried tensor lowers to a scatter;
    concatenating static slices is a fused copy.
    """
    return jnp.concatenate([A[:k], row[None], A[k + 1 :]], axis=0)


def to_fminor(A):
    """(F, m, n) -> (m, n, F)."""
    return jnp.transpose(A, (1, 2, 0))


def to_fmajor(A):
    """(m, n, F) -> (F, m, n)."""
    return jnp.transpose(A, (2, 0, 1))


def mat_h_fm(A):
    """Hermitian transpose: (m, n, F) -> (n, m, F)."""
    return jnp.conj(jnp.transpose(A, (1, 0, 2)))


def matmul_fm(A, B):
    """(m, k, F) @ (k, n, F) -> (m, n, F) by broadcast-reduce (full f32)."""
    return jnp.sum(A[:, :, None, :] * B[None, :, :, :], axis=1)


def matvec_fm(A, x):
    """(m, n, F) @ (n, F) -> (m, F)."""
    return jnp.sum(A * x[None, :, :], axis=1)


def vecmat_fm(x, A):
    """(m, F) @ (m, n, F) -> (n, F)."""
    return jnp.sum(x[:, None, :] * A, axis=0)


def _dead(den, ref):
    """(guarded denominator, ok mask) for the dead-bin convention.

    A pivot/determinant below ``sqrt(tiny) * ref`` (~1e-19 relative in
    f32) is an essentially-exact zero: the solve writes ZEROS there (a
    "dead bin" — the IVA chain's renormalization floors turn a zero row
    into a zero output that later epochs re-aim), because dividing by a
    floored-tiny value creates ~1e37 rows that overflow downstream f32
    arithmetic into NaN (docs/DESIGN.md §4b). ``ref`` is the natural
    magnitude of the numerator the denominator will divide (matrix scale
    for pivots, scale^2 for the 2x2 adjugate determinant), so the
    quotient stays below ~1e19 and the pow-2 clamps take it from there.

    The threshold is deliberately FAR below any legitimate conditioning:
    ill-conditioned-but-nonsingular bins (cond 1e6-1e18) keep producing
    their usual low-accuracy solutions — IVA's renormalization uses them
    productively, and zeroing them was measured to cost several dB on
    near-rank-1 weighted covariances (strong bins of N=1 runs, where
    det << max|A|^m is the healthy state).
    """
    rd = den.dtype if not jnp.iscomplexobj(den) else den.real.dtype
    thr = jnp.sqrt(jnp.finfo(rd).tiny) * ref
    ok = jnp.abs(den) > thr
    return jnp.where(ok, den, 1.0), ok


def clamp_pow2_fm(A, threshold_exp: float = 20.0):
    """Exact power-of-2 down-scaling of huge bin-minor tensors (..., F).

    Near-dead bins (pivot just above the ``_dead`` threshold) can make the
    IP solve output huge, overflowing the f32 quadratic form
    ``w^H V w`` to NaN. Call sites are scale-invariant (the IP
    normalization cancels any per-bin scale exactly), so bins with
    max|.| > 2^threshold_exp are divided by a power of two — an EXACT
    float operation, leaving healthy bins bit-unchanged.
    """
    mag = jnp.max(jnp.abs(A), axis=tuple(range(A.ndim - 1)), keepdims=True)
    exp = jnp.ceil(jnp.log2(jnp.maximum(mag, 1.0)))
    exp = jnp.minimum(exp, 120.0)  # keep the scale itself finite in f32
    scale = jnp.exp2(jnp.where(exp > threshold_exp, exp, 0.0))
    return A / scale.astype(A.real.dtype)


def quad_form_fm(w, Vp):
    """Guarded Hermitian quadratic form ``w^H V w`` per bin.

    w: (m, F), Vp: (m, m, F). Returns ``(s, good)`` where s (F,) is the
    real quadratic form and good (F,) bool marks bins where s carries
    significant bits. On knife-edge bins the form cancels catastrophically:
    the computed value can be <= 0 or pure rounding noise, and an absolute
    floor (``tiny``) then amplifies the row by ~1e19 instead of normalizing
    it — the runaway that collapsed the r3c sweep's m2_n2 ip2 instance
    (all bins die through the cross-bin activation coupling within two
    epochs). ``good`` compares s against the sum of its term magnitudes:
    s <= 4*eps*ref means zero significant bits — the caller should keep
    the previous row for those bins instead of writing a garbage one.
    """
    t = jnp.conj(w)[:, None, :] * Vp * w[None, :, :]  # (m, m, F)
    tr = jnp.real(t)
    s = jnp.sum(tr, axis=(0, 1))
    # imaginary parts cancel exactly by Hermitian symmetry; the real-part
    # term magnitudes measure the cancellation the sum went through
    ref = jnp.sum(jnp.abs(tr), axis=(0, 1))
    eps = jnp.finfo(s.dtype).eps
    good = s > 4.0 * eps * ref
    return s, good


def _adj2_solve(A, B):
    s = jnp.max(jnp.abs(A), axis=(0, 1))
    det, ok = _dead(A[0, 0] * A[1, 1] - A[0, 1] * A[1, 0], s * s)
    inv = jnp.stack(
        [
            jnp.stack([A[1, 1], -A[0, 1]], axis=0),
            jnp.stack([-A[1, 0], A[0, 0]], axis=0),
        ],
        axis=0,
    ) / det[None, None, :]
    inv = jnp.where(ok[None, None, :], inv, 0.0)
    return matmul_fm(inv, B)


def gauss_solve_fm(A, B):
    """Batched solve A X = B, bin-minor: A (m, m, F), B (m, k, F) -> (m, k, F).

    Mask-pivoted Gauss-Jordan unrolled over the static m (same elimination
    and pivot choice as ``linalg.gauss_solve``); m == 2 uses the closed-form
    adjugate inverse. No gathers anywhere: pivot selection, extraction and
    the final row permutation are all one-hot mask reductions.
    """
    m = A.shape[0]
    if m == 1:
        den, ok = _dead(A[0, 0], jnp.abs(A[0, 0]))  # dead only at exact 0
        return jnp.where(ok[None, None, :], B / den[None, None, :], 0.0)
    if m == 2:
        return _adj2_solve(A, B)
    F = A.shape[2]
    k = B.shape[1]
    Ab = jnp.concatenate([A, B], axis=1)  # (m, m+k, F)
    scale0 = jnp.max(jnp.abs(A), axis=(0, 1))  # (F,) dead-pivot reference
    avail = jnp.ones((m, F), bool)
    sels = []
    rows = jnp.arange(m)
    for i in range(m):
        mag = jnp.where(avail, jnp.abs(Ab[:, i, :]), -1.0)  # (m, F)
        p = jnp.argmax(mag, axis=0).astype(jnp.int32)  # (F,)
        sel = rows[:, None] == p[None, :]  # (m, F) one-hot over rows
        piv = jnp.sum(jnp.where(sel[:, None, :], Ab, 0.0), axis=0)  # (m+k, F)
        den, ok = _dead(piv[i], scale0)  # rank-deficient -> zero the row
        piv = jnp.where(ok[None, :], piv / den[None, :], 0.0)
        factor = jnp.where(sel, 0.0, Ab[:, i, :])  # (m, F)
        Ab = Ab - factor[:, None, :] * piv[None, :, :]
        Ab = jnp.where(sel[:, None, :], piv[None, :, :], Ab)
        avail = avail & ~sel
        sels.append(sel)
    # solution i lives in tableau row sels[i]; apply the permutation as one
    # mask contraction (solution rows are orthogonal one-hots)
    P = jnp.stack(sels, axis=0).astype(Ab.real.dtype)  # (m, m, F)
    return jnp.sum(P[:, :, None, :] * Ab[None, :, m:, :], axis=1)  # (m, k, F)


def solve_vec_fm(A, b):
    """A x = b: A (m, m, F), b (m, F) -> (m, F)."""
    return gauss_solve_fm(A, b[:, None, :])[:, 0, :]


def solve_mat_fm(A, B):
    """A X = B with matrix rhs, bin-minor."""
    return gauss_solve_fm(A, B)
