"""Batched small-linalg kernels vs LAPACK (SURVEY.md §7.4 hard part #3)."""

import numpy as np
import pytest

import jax.numpy as jnp

from overiva_jax.ops.fminor import gauss_solve_fm
from overiva_jax.ops.linalg import gauss_solve, small_inv


@pytest.mark.parametrize("m,k", [(2, 1), (3, 2), (8, 1), (8, 8), (5, 3)])
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_gauss_solve_matches_lapack(rng, m, k, dtype):
    F = 257
    A = (rng.standard_normal((F, m, m)) + 1j * rng.standard_normal((F, m, m))).astype(dtype)
    B = (rng.standard_normal((F, m, k)) + 1j * rng.standard_normal((F, m, k))).astype(dtype)
    X = np.asarray(gauss_solve(jnp.asarray(A), jnp.asarray(B)))
    Xref = np.linalg.solve(A.astype(np.complex128), B.astype(np.complex128))
    tol = 1e-4 if dtype == np.complex64 else 1e-10
    np.testing.assert_allclose(X, Xref, rtol=tol, atol=tol)


def test_gauss_solve_needs_pivoting(rng):
    """Zero leading pivot: fails without row exchanges."""
    F, m = 64, 4
    A = rng.standard_normal((F, m, m)) + 1j * rng.standard_normal((F, m, m))
    A[:, 0, 0] = 0.0
    b = rng.standard_normal((F, m, 1)) + 1j * rng.standard_normal((F, m, 1))
    X = np.asarray(gauss_solve(jnp.asarray(A), jnp.asarray(b)))
    np.testing.assert_allclose(X, np.linalg.solve(A, b), rtol=1e-9, atol=1e-9)


def test_small_inv(rng):
    F, m = 65, 6
    A = rng.standard_normal((F, m, m)) + 1j * rng.standard_normal((F, m, m))
    Ai = np.asarray(small_inv(jnp.asarray(A)))
    np.testing.assert_allclose(Ai @ A, np.tile(np.eye(m), (F, 1, 1)), atol=1e-9)


def test_gauss_solve_hermitian_psd(rng):
    """The hot-loop case: WV with V Hermitian PSD-weighted covariance."""
    F, m = 513, 8
    Xd = rng.standard_normal((200, F, m)) + 1j * rng.standard_normal((200, F, m))
    V = np.einsum("tfm,tfn->fmn", Xd, np.conj(Xd)) / 200
    W = np.tile(np.eye(m, dtype=complex), (F, 1, 1))
    WV = W @ V
    e = np.zeros((F, m, 1), complex)
    e[:, 2, 0] = 1.0
    X = np.asarray(gauss_solve(jnp.asarray(WV), jnp.asarray(e)))
    np.testing.assert_allclose(X, np.linalg.solve(WV, e), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("m", [2, 3, 5, 8])
@pytest.mark.parametrize("cond", [1e4, 1e5, 1e6])
def test_gauss_solve_forward_error_within_cond_eps(m, cond):
    """complex64 solves of ill-conditioned Hermitian systems (the lowest
    bins' covariances on a small array) keep their forward error below
    cond * eps, in both layouts. A closed-form 3x3 adjugate inverse read
    3-69x cond * eps here, and its lost digits spread through the joint
    activations to every bin of a 30-epoch N=3 separation
    (docs/DESIGN.md §4c)."""
    rng = np.random.default_rng(4)
    F = 256
    Q, _ = np.linalg.qr(
        rng.standard_normal((F, m, m)) + 1j * rng.standard_normal((F, m, m))
    )
    ew = np.geomspace(1.0, 1.0 / cond, m)
    A = ((Q * ew) @ Q.conj().transpose(0, 2, 1)).astype(np.complex64)
    B = (rng.standard_normal((F, m, 2))
         + 1j * rng.standard_normal((F, m, 2))).astype(np.complex64)
    ref = np.linalg.solve(A.astype(np.complex128), B.astype(np.complex128))
    bound = cond * np.finfo(np.float32).eps
    for X in (
        np.asarray(gauss_solve(jnp.asarray(A), jnp.asarray(B))),
        np.asarray(gauss_solve_fm(jnp.asarray(A.transpose(1, 2, 0)),
                                  jnp.asarray(B.transpose(1, 2, 0)))
                   ).transpose(2, 0, 1),
    ):
        err = np.abs(X - ref).max(axis=(1, 2)) / np.abs(ref).max(axis=(1, 2))
        assert err.max() <= bound, (err.max(), bound)
