"""Bin-minor (m, n, F) linalg kernels vs LAPACK (docs/DESIGN.md §2b)."""

import numpy as np
import pytest

import jax.numpy as jnp

from overiva_jax.ops.fminor import (
    gauss_solve_fm,
    mat_h_fm,
    matmul_fm,
    matvec_fm,
    solve_vec_fm,
    to_fmajor,
    to_fminor,
    vecmat_fm,
)


def _c(rng, shape, dtype=np.complex64):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(
        dtype
    )


@pytest.mark.parametrize("m,k", [(1, 1), (2, 3), (3, 5), (8, 1), (8, 8), (5, 3)])
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_gauss_solve_fm_matches_lapack(rng, m, k, dtype):
    F = 257
    A = _c(rng, (F, m, m), dtype)
    B = _c(rng, (F, m, k), dtype)
    Xp = gauss_solve_fm(to_fminor(jnp.asarray(A)), to_fminor(jnp.asarray(B)))
    X = np.asarray(to_fmajor(Xp))
    Xref = np.linalg.solve(A.astype(np.complex128), B.astype(np.complex128))
    tol = 2e-4 if dtype == np.complex64 else 1e-10
    np.testing.assert_allclose(X, Xref, rtol=tol, atol=tol)


def test_gauss_solve_fm_needs_pivoting(rng):
    """Zero leading pivot: fails without row exchanges (the masked GJ path)."""
    F, m = 64, 5
    A = _c(rng, (F, m, m), np.complex128)
    A[:, 0, 0] = 0.0
    b = _c(rng, (F, m, 1), np.complex128)
    Xp = gauss_solve_fm(to_fminor(jnp.asarray(A)), to_fminor(jnp.asarray(b)))
    np.testing.assert_allclose(
        np.asarray(to_fmajor(Xp)), np.linalg.solve(A, b), rtol=1e-9, atol=1e-9
    )


def test_solve_vec_fm(rng):
    F, m = 129, 8
    A = _c(rng, (F, m, m), np.complex128)
    b = _c(rng, (F, m), np.complex128)
    xp = solve_vec_fm(to_fminor(jnp.asarray(A)), jnp.asarray(b).T)
    ref = np.linalg.solve(A, b[..., None])[..., 0]
    np.testing.assert_allclose(np.asarray(xp).T, ref, rtol=1e-9, atol=1e-9)


def test_matmul_matvec_vecmat_math(rng):
    F, m, k, n = 65, 4, 6, 3
    A = _c(rng, (F, m, k), np.complex128)
    B = _c(rng, (F, k, n), np.complex128)
    x = _c(rng, (F, k), np.complex128)
    got = np.asarray(to_fmajor(matmul_fm(to_fminor(jnp.asarray(A)), to_fminor(jnp.asarray(B)))))
    np.testing.assert_allclose(got, A @ B, rtol=1e-12, atol=1e-12)
    got = np.asarray(matvec_fm(to_fminor(jnp.asarray(A)), jnp.asarray(x).T)).T
    np.testing.assert_allclose(got, np.einsum("fmk,fk->fm", A, x), rtol=1e-12, atol=1e-12)
    y = _c(rng, (F, k), np.complex128)
    got = np.asarray(vecmat_fm(jnp.asarray(y).T, to_fminor(jnp.asarray(B)))).T
    np.testing.assert_allclose(got, np.einsum("fk,fkn->fn", y, B), rtol=1e-12, atol=1e-12)


def test_mat_h_fm(rng):
    F, m, n = 33, 3, 5
    A = _c(rng, (F, m, n), np.complex64)
    got = np.asarray(to_fmajor(mat_h_fm(to_fminor(jnp.asarray(A)))))
    np.testing.assert_allclose(got, np.conj(A).transpose(0, 2, 1))


def test_fm_hot_loop_case(rng):
    """The OverIVA WV solve shape: Hermitian-PSD-derived 8x8 with e_k rhs."""
    F, m = 513, 8
    Xd = rng.standard_normal((200, F, m)) + 1j * rng.standard_normal((200, F, m))
    V = np.einsum("tfm,tfn->fmn", Xd, np.conj(Xd)) / 200
    WV = np.tile(np.eye(m, dtype=complex), (F, 1, 1)) @ V
    e = np.zeros((F, m, 1), complex)
    e[:, 2, 0] = 1.0
    Xp = gauss_solve_fm(to_fminor(jnp.asarray(WV)), to_fminor(jnp.asarray(e)))
    np.testing.assert_allclose(
        np.asarray(to_fmajor(Xp)), np.linalg.solve(WV, e), rtol=1e-8, atol=1e-10
    )
