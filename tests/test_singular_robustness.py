"""Knife-edge robustness: singular systems must yield finite output, never
NaN/inf poisoning (docs/DESIGN.md §4b; observed in the WASPAA sweep on
overiva-gauss m8_n3 / overiva-ip2 m2_n2 before the _safe_denom floors)."""

import numpy as np
import pytest

import jax.numpy as jnp

from overiva_jax import api
from overiva_jax.ops.fminor import gauss_solve_fm, quad_form_fm
from overiva_jax.ops.linalg import gauss_solve


@pytest.mark.parametrize("m", [1, 2, 3, 5, 8])
def test_gauss_solve_singular_is_finite(m):
    """Exactly singular (rank-1 or zero) systems: finite output, no NaN."""
    rng = np.random.default_rng(0)
    F = 7
    u = rng.standard_normal((F, m)) + 1j * rng.standard_normal((F, m))
    A1 = (u[:, :, None] * u[:, None, :].conj()).astype(np.complex64)  # rank 1
    A0 = np.zeros((F, m, m), np.complex64)
    B = (rng.standard_normal((F, m, 2)) + 0j).astype(np.complex64)
    for A in (A1, A0):
        X = np.asarray(gauss_solve(jnp.asarray(A), jnp.asarray(B)))
        assert np.all(np.isfinite(X)), "F-major solve produced NaN/inf"
        Xf = np.asarray(
            gauss_solve_fm(
                jnp.asarray(A.transpose(1, 2, 0)),
                jnp.asarray(B.transpose(1, 2, 0)),
            )
        )
        assert np.all(np.isfinite(Xf)), "bin-minor solve produced NaN/inf"


def test_gauss_solve_regular_unchanged():
    """Floors must not perturb well-conditioned solves."""
    rng = np.random.default_rng(1)
    F, m = 11, 4
    A = rng.standard_normal((F, m, m)) + 1j * rng.standard_normal((F, m, m))
    A = (A @ A.conj().transpose(0, 2, 1) + 3 * np.eye(m)).astype(np.complex64)
    B = (rng.standard_normal((F, m, 3)) + 0j).astype(np.complex64)
    X = np.asarray(gauss_solve(jnp.asarray(A), jnp.asarray(B)))
    ref = np.linalg.solve(A.astype(np.complex128), B.astype(np.complex128))
    np.testing.assert_allclose(X, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("m", [2, 3, 5, 8])
@pytest.mark.parametrize("spread", [1e-4, 1e-6])
def test_gauss_solve_spread_eigenvalues_not_zeroed(m, spread):
    """Near-rank-1 Hermitian systems (large eigenvalue spread — the
    healthy state of an N=1 weighted covariance) must be SOLVED, not
    declared dead: an early eps*scale^m gate zeroed these and cost
    3-8 dB on the N=1 sweep cells (docs/DESIGN.md 4b). At cond 1e4 the
    solve must also be accurate; at cond 1e6 f32 keeps few digits (the
    m=2 adjugate form amplifies eps*cond), so only magnitude-level
    agreement — which zeroing fails by 100% — is required."""
    rng = np.random.default_rng(3)
    F = 5
    Q, _ = np.linalg.qr(
        rng.standard_normal((F, m, m)) + 1j * rng.standard_normal((F, m, m))
    )
    ew = np.geomspace(1.0, spread, m)[None, :] * np.ones((F, 1))
    A = (Q * ew[:, None, :]) @ Q.conj().transpose(0, 2, 1)
    A = A.astype(np.complex64)
    B = np.zeros((F, m, 1), np.complex64)
    B[:, 0, 0] = 1.0
    ref = np.linalg.solve(A.astype(np.complex128), B.astype(np.complex128))
    tol = 0.05 if spread == 1e-4 else None
    for X in (
        np.asarray(gauss_solve(jnp.asarray(A), jnp.asarray(B))),
        np.asarray(
            gauss_solve_fm(
                jnp.asarray(A.transpose(1, 2, 0)),
                jnp.asarray(B.transpose(1, 2, 0)),
            )
        ).transpose(2, 0, 1),
    ):
        assert np.all(np.isfinite(X))
        if tol is not None:
            rel = np.abs(X - ref) / np.abs(ref).max(axis=(1, 2), keepdims=True)
            assert rel.max() < tol, f"solve off by {rel.max():.2%}"
        else:  # magnitude sanity: a zeroed bin is off by 10^6, not 10x
            ratio = np.abs(X).max(axis=(1, 2)) / np.abs(ref).max(axis=(1, 2))
            assert np.all((ratio > 0.1) & (ratio < 10.0)), ratio


def test_quad_form_guard():
    """quad_form_fm: healthy forms are accurate with good=True; forms that
    cancel to rounding noise report good=False (the caller then keeps the
    old demixing row instead of normalizing by garbage — the fix for the
    r3c m2_n2 batch collapse, where an absolute floor amplified knife-edge
    rows by ~1e19 and the blow-up killed every bin through the joint
    activations within two epochs)."""
    rng = np.random.default_rng(7)
    F, m = 9, 4
    A = rng.standard_normal((F, m, m)) + 1j * rng.standard_normal((F, m, m))
    V = (A @ A.conj().transpose(0, 2, 1) + np.eye(m)).astype(np.complex64)
    w = (rng.standard_normal((F, m)) + 1j * rng.standard_normal((F, m))).astype(
        np.complex64
    )
    s, good = quad_form_fm(
        jnp.asarray(w.T), jnp.asarray(V.transpose(1, 2, 0))
    )
    ref = np.einsum("fi,fij,fj->f", w.conj(), V.astype(np.complex128), w).real
    assert np.all(np.asarray(good))
    np.testing.assert_allclose(np.asarray(s), ref, rtol=1e-5)

    # catastrophic cancellation: V with a 1e12-spread spectrum and w in
    # the near-null space -> f32 computes noise; the guard must trip
    Q, _ = np.linalg.qr(
        rng.standard_normal((F, m, m)) + 1j * rng.standard_normal((F, m, m))
    )
    ew = np.geomspace(1.0, 1e-12, m)[None, :] * np.ones((F, 1))
    Vs = ((Q * ew[:, None, :]) @ Q.conj().transpose(0, 2, 1)).astype(
        np.complex64
    )
    wn = Q[:, :, -1].astype(np.complex64) * 1e4  # null direction, large
    _, good2 = quad_form_fm(
        jnp.asarray(wn.T), jnp.asarray(Vs.transpose(1, 2, 0))
    )
    assert not np.any(np.asarray(good2)), "guard failed to trip"


@pytest.mark.parametrize("algo,kw", [
    ("overiva", {"model": "gauss", "init_eig": True, "n_src": 2}),
    ("overiva_ip2", {"n_src": 2}),
    ("ilrma", {}),
    ("tip", {"n_src": 2, "taps": 2, "delay": 1, "warm_iter": 3}),
])
def test_degenerate_mixture_stays_finite(algo, kw):
    """A mixture with a duplicated channel (rank-deficient Cx -> singular
    update systems) must come out finite; pre-floor code NaN'd here."""
    rng = np.random.default_rng(2)
    T, F, M = 40, 17, 4
    X = (rng.standard_normal((T, F, M)) + 1j * rng.standard_normal((T, F, M)))
    X[:, :, -1] = X[:, :, -2]  # duplicated mic
    X = X.astype(np.complex64)
    Y = getattr(api, algo)(X, n_iter=8, **kw)
    assert np.all(np.isfinite(Y)), f"{algo} produced NaN/inf on singular mix"


@pytest.mark.parametrize("algo,kw", [
    ("overiva", {"n_src": 2}),
    ("overiva_ip2", {"n_src": 2}),
    ("ilrma", {}),
    ("tip", {"taps": 2, "delay": 1, "warm_iter": 3}),
])
def test_near_singular_mixing_no_collapse(algo, kw):
    """Near-singular 2x2 mixing (columns almost parallel): every bin is
    knife-edge, so the guarded normalizer must freeze unresolvable rows
    rather than amplify them. Output must be finite AND carry energy —
    the pre-guard code either NaN'd or (with the dead-bin gate alone)
    collapsed to exact zeros within a few epochs."""
    rng = np.random.default_rng(11)
    T, F, M = 60, 33, 2
    S = (rng.standard_normal((T, F, M)) + 1j * rng.standard_normal((T, F, M)))
    mix_mat = np.array([[1.0, 1.0], [1.0, 1.0 + 3e-7]], np.complex64)
    X = (S @ mix_mat.T).astype(np.complex64)
    Y = np.asarray(getattr(api, algo)(X, n_iter=10, **kw))
    assert np.all(np.isfinite(Y)), f"{algo} NaN/inf on near-singular mixing"
    e = float(np.sum(np.abs(Y) ** 2))
    assert e > 1e-6 * float(np.sum(np.abs(X) ** 2)), (
        f"{algo} collapsed to (near-)zero output: energy {e:.3e}"
    )
