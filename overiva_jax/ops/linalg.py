"""Batched small complex linear algebra for the IVA hot loop.

Per-frequency-bin (F-batched) M x M solves and eigendecompositions
(SURVEY.md §2.4: the reference gets these from LAPACK gufuncs; here they are
XLA batched ops — all 2049 bins run as one fused program). Whether any of
them deserves a hand-written GPU kernel is an open measurement (ROADMAP).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

__all__ = [
    "solve_vec", "solve_mat", "gauss_solve", "small_inv", "eigh",
    "align_eigvec_phase", "matvec", "mat_h",
]

# Contraction precision for the f32/c64 path: HIGHEST keeps float32
# contractions in full float32 (the GPU's default and HIGH both run them
# as TF32, ~1e-3 relative) — required for parity with the f64 oracle.
# tests/test_precision_audit.py checks the served programs for it.
PRECISION = lax.Precision.HIGHEST


def mat_h(A):
    """Batched Hermitian transpose: (..., m, n) -> (..., n, m)."""
    return jnp.conj(jnp.swapaxes(A, -1, -2))


def matvec(A, x):
    """Batched matrix-vector: (..., m, n) @ (..., n) -> (..., m)."""
    return jnp.einsum("...mn,...n->...m", A, x, precision=PRECISION)


def _dead(den, ref):
    """(guarded denominator, ok mask): F-major twin of
    ``ops.fminor._dead`` — pivots/determinants below ``sqrt(tiny) * ref``
    (essentially-exact zeros; ~1e-19 relative in f32) mark a bin whose
    solution is written as ZEROS (dead bin) instead of inf/NaN. See the
    fminor docstring for why the threshold must sit far below legitimate
    ill-conditioning (docs/DESIGN.md §4b)."""
    rd = den.dtype if not jnp.iscomplexobj(den) else den.real.dtype
    thr = jnp.sqrt(jnp.finfo(rd).tiny) * ref
    ok = jnp.abs(den) > thr
    return jnp.where(ok, den, 1.0), ok


def clamp_pow2(A, threshold_exp: float = 20.0):
    """Exact power-of-2 down-scaling of huge F-major tensors (F, ...).

    F-major twin of ``ops.fminor.clamp_pow2_fm`` (see there): keeps
    knife-edge bins' solve outputs small enough that downstream f32
    quadratic forms can't overflow, while healthy bins are bit-unchanged.
    """
    mag = jnp.max(jnp.abs(A), axis=tuple(range(1, A.ndim)), keepdims=True)
    exp = jnp.ceil(jnp.log2(jnp.maximum(mag, 1.0)))
    exp = jnp.minimum(exp, 120.0)
    scale = jnp.exp2(jnp.where(exp > threshold_exp, exp, 0.0))
    return A / scale.astype(A.real.dtype)


def gauss_solve(A, B):
    """Batched small-matrix solve A X = B by Gauss-Jordan with partial pivoting.

    A: (F, m, m), B: (F, m, k); m is STATIC and small (the mic count, <= ~16).
    Unrolled over m, fully vectorized over the F batch — every step is a few
    elementwise passes over the (F, m, m+k) tableau. Replaces
    ``jnp.linalg.solve``, whose batched tiny LU factorization lowered to a
    slow loop on the first accelerator this ran on; how the two compare on
    the GPU is an open measurement (ROADMAP).

    Rows are never physically exchanged: pivoting is done with one-hot masks
    instead of a per-step row gather of the whole tableau, and the
    accumulated permutation is applied once at the end.

    m == 2 uses the closed-form adjugate inverse instead. m == 3 must not:
    a 3x3 adjugate loses up to ~70x cond*eps on the near-singular lowest
    bins of a small array (docs/DESIGN.md §4c).
    """
    F, m, _ = A.shape
    if m == 1:
        den, ok = _dead(A[:, :, 0:1], jnp.abs(A[:, :, 0:1]))
        return jnp.where(ok, B / den, 0.0)
    if m == 2:
        s = jnp.max(jnp.abs(A), axis=(1, 2))
        det, ok = _dead(
            A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0], s * s
        )
        inv = (
            jnp.stack(
                [
                    jnp.stack([A[:, 1, 1], -A[:, 0, 1]], axis=1),
                    jnp.stack([-A[:, 1, 0], A[:, 0, 0]], axis=1),
                ],
                axis=1,
            )
            / det[:, None, None]
        )
        inv = jnp.where(ok[:, None, None], inv, 0.0)
        return jnp.matmul(inv, B, precision=PRECISION)
    Ab = jnp.concatenate([A, B], axis=2)  # (F, m, m+k)
    scale0 = jnp.max(jnp.abs(A), axis=(1, 2))  # (F,) dead-pivot reference
    avail = jnp.ones((F, m), bool)  # rows not yet chosen as pivots
    perm = jnp.zeros((F, m), jnp.int32)  # perm[i] = tableau row of solution i
    rows = jnp.arange(m)
    for i in range(m):
        # partial pivot: strongest still-available row in column i
        mag = jnp.where(avail, jnp.abs(Ab[:, :, i]), -1.0)
        p = jnp.argmax(mag, axis=1).astype(jnp.int32)  # (F,)
        sel = rows[None, :] == p[:, None]  # (F, m) one-hot
        piv_row = jnp.sum(jnp.where(sel[:, :, None], Ab, 0.0), axis=1)
        den, ok = _dead(piv_row[:, i], scale0)  # rank-deficient -> zero row
        piv_row = jnp.where(ok[:, None], piv_row / den[:, None], 0.0)
        factor = jnp.where(sel, 0.0, Ab[:, :, i])  # keep the pivot row itself
        Ab = Ab - factor[:, :, None] * piv_row[:, None, :]
        Ab = jnp.where(sel[:, :, None], piv_row[:, None, :], Ab)
        avail = avail & ~sel
        perm = perm.at[:, i].set(p)
    return jnp.take_along_axis(Ab[:, :, m:], perm[:, :, None], axis=1)


def small_inv(A):
    """Batched small-matrix inverse via :func:`gauss_solve` against I."""
    F, m, _ = A.shape
    eye = jnp.broadcast_to(jnp.eye(m, dtype=A.dtype), (F, m, m))
    return gauss_solve(A, eye)


def solve_vec(A, b):
    """Batched solve A x = b with vector rhs: (F, m, m), (F, m) -> (F, m)."""
    return gauss_solve(A, b[..., None])[..., 0]


def solve_mat(A, B):
    """Batched solve A X = B with matrix rhs."""
    return gauss_solve(A, B)


def eigh(A):
    """Batched Hermitian eigendecomposition, eigenvalues ascending."""
    return jnp.linalg.eigh(A)


def align_eigvec_phase(E):
    """Deterministic eigenvector phase: largest-|.| component real-positive.

    E: (F, M, K) columns are eigenvectors. Matches the oracle's convention
    (``oracle.models.align_eigvec_phase``) so eigh-initialized trajectories
    coincide between the LAPACK and XLA backends.
    """
    idx = jnp.argmax(jnp.abs(E), axis=1)  # (F, K)
    anchor = jnp.take_along_axis(E, idx[:, None, :], axis=1)[:, 0, :]
    phase = anchor / jnp.maximum(jnp.abs(anchor), 1e-30).astype(E.real.dtype)
    return E * jnp.conj(phase)[:, None, :]
