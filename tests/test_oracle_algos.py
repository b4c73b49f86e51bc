"""Oracle algorithm invariants (SURVEY.md §4): IP normalization, OC residual,
OverIVA(N=M) == AuxIVA, model weights, projection back, separation quality.

Separation quality here is checked with a cheap STFT-domain SIR proxy; the
full time-domain bss_eval tests live in test_bss_eval.py / integration tests.
"""

import numpy as np
import pytest

from overiva_jax.oracle import (
    activations,
    apply_projection_back,
    auxiva,
    auxiva_pca,
    ogive,
    overiva,
    pca,
    projection_back,
)

from helpers import make_mixture, stft_mixture


def stft_sir_matrix(Y, S):
    """Correlation-power matrix between separated Y (T,F,K) and source STFTs
    S (N,T,F): gain[k,n] = |<Y_k, S_n>|^2 / (||Y_k||^2 ||S_n||^2)."""
    K = Y.shape[2]
    N = S.shape[0]
    G = np.zeros((K, N))
    for k in range(K):
        for n in range(N):
            num = np.abs(np.vdot(S[n], Y[:, :, k])) ** 2
            G[k, n] = num / (np.vdot(Y[:, :, k], Y[:, :, k]).real * np.vdot(S[n], S[n]).real)
    return G


def separation_success(Y, premix_stft, min_ratio=10.0):
    """Each output should be dominated by a distinct source."""
    G = stft_sir_matrix(Y, premix_stft)
    picked = set()
    for k in range(G.shape[0]):
        order = np.argsort(G[k])[::-1]
        best = order[0]
        ratio = G[k, best] / max(G[k, order[1]], 1e-12) if G.shape[1] > 1 else np.inf
        if best in picked or ratio < min_ratio:
            return False, G
        picked.add(best)
    return True, G


@pytest.fixture(scope="module")
def mixture22():
    rng = np.random.default_rng(7)
    mix, premix, src = make_mixture(rng, n_src=2, n_mics=2, n_samples=20000)
    X = stft_mixture(mix, nfft=256)
    P = np.stack([stft_mixture(premix[k], nfft=256)[:, :, 0] for k in range(2)])
    return X, P


@pytest.fixture(scope="module")
def mixture52():
    rng = np.random.default_rng(11)
    mix, premix, src = make_mixture(rng, n_src=2, n_mics=5, n_samples=20000)
    X = stft_mixture(mix, nfft=256)
    P = np.stack([stft_mixture(premix[k], nfft=256)[:, :, 0] for k in range(2)])
    return X, P


def test_activations_values(rng):
    Y = rng.standard_normal((4, 3, 2)) + 1j * rng.standard_normal((4, 3, 2))
    r, phi = activations(Y, "laplace")
    expect = 2 * np.sqrt(np.sum(np.abs(Y) ** 2, axis=1))
    np.testing.assert_allclose(r, expect)
    np.testing.assert_allclose(phi, 1 / expect)
    r2, _ = activations(Y, "gauss")
    np.testing.assert_allclose(r2, np.sum(np.abs(Y) ** 2, axis=1) / 3)


def test_projection_back_lstsq(rng):
    T, F, K = 50, 9, 2
    Y = rng.standard_normal((T, F, K)) + 1j * rng.standard_normal((T, F, K))
    ref = rng.standard_normal((T, F)) + 1j * rng.standard_normal((T, F))
    z = projection_back(Y, ref)
    # conj(z) must equal the per-(f,k) least-squares scale fitting ref ~ c*Y
    for f in range(F):
        for k in range(K):
            c, *_ = np.linalg.lstsq(Y[:, f, k : k + 1], ref[:, f], rcond=None)
            np.testing.assert_allclose(np.conj(z[f, k]), c[0], atol=1e-10)


def test_projection_back_recovers_scaling(rng):
    # If Y is an exact per-(f,k) rescaling of ref, projection back undoes it.
    T, F = 40, 5
    ref = rng.standard_normal((T, F)) + 1j * rng.standard_normal((T, F))
    scales = rng.standard_normal((F, 1)) + 1j * rng.standard_normal((F, 1))
    Y = ref[:, :, None] * scales[None, :, :]
    out = apply_projection_back(Y, ref)
    np.testing.assert_allclose(out[:, :, 0], ref, atol=1e-10)


def test_auxiva_ip_normalization(mixture22):
    """After convergence-ish, every row satisfies w^H V w == 1 by construction;
    check the returned demixing matrix is finite and non-singular."""
    X, P = mixture22
    Y, W = auxiva(X, n_iter=5, proj_back=False, return_filters=True)
    assert np.all(np.isfinite(W))
    dets = np.linalg.det(W)
    assert np.all(np.abs(dets) > 1e-12)


def test_auxiva_separates(mixture22):
    X, P = mixture22
    Y = auxiva(X, n_iter=30)
    ok, G = separation_success(Y, P)
    assert ok, f"AuxIVA failed to separate: gain matrix {G}"


def test_auxiva_rejects_overdetermined(mixture52):
    X, P = mixture52
    with pytest.raises(ValueError):
        auxiva(X, n_src=2)


def test_overiva_oc_residual(mixture52):
    """Orthogonal constraint: [J, -I] Cx W1^H ~ 0 after every epoch."""
    X, P = mixture52
    N = 2
    Y, W_hat = overiva(X, n_src=N, n_iter=4, proj_back=False, return_filters=True)
    T = X.shape[0]
    Cx = np.einsum("tfm,tfn->fmn", X, np.conj(X)) / T
    W1 = W_hat[:, :N, :]
    B = W_hat[:, N:, :]  # [J, -I]
    resid = B @ Cx @ np.conj(np.swapaxes(W1, 1, 2))
    scale = np.abs(Cx).max()
    assert np.abs(resid).max() / scale < 1e-8


def test_overiva_background_block(mixture52):
    X, P = mixture52
    N = 2
    _, W_hat = overiva(X, n_src=N, n_iter=2, proj_back=False, return_filters=True)
    M = X.shape[2]
    expect = -np.eye(M - N)
    np.testing.assert_allclose(
        W_hat[:, N:, N:], np.tile(expect, (W_hat.shape[0], 1, 1)), atol=1e-12
    )


def test_overiva_equals_auxiva_when_determined(mixture22):
    X, P = mixture22
    Ya = auxiva(X, n_iter=10, proj_back=True)
    Yo = overiva(X, n_src=2, n_iter=10, proj_back=True)
    np.testing.assert_allclose(Ya, Yo, atol=1e-8)


def test_overiva_separates(mixture52):
    X, P = mixture52
    Y = overiva(X, n_src=2, n_iter=30)
    ok, G = separation_success(Y, P)
    assert ok, f"OverIVA failed to separate: gain matrix {G}"


@pytest.fixture(scope="module")
def mixture52_noisy():
    # The time-varying Gauss model favors maximally spiky outputs; in a large
    # background subspace (M >> N) with near-zero noise floor it can collapse
    # onto degenerate "silence" directions (an inherent property of the
    # algorithm, not of this implementation). A 20 dB noise floor keeps the
    # problem well-posed, matching the reference's noisy room benchmarks.
    rng = np.random.default_rng(11)
    mix, premix, src = make_mixture(rng, n_src=2, n_mics=5, n_samples=20000, snr_db=20.0)
    X = stft_mixture(mix, nfft=256)
    P = np.stack([stft_mixture(premix[k], nfft=256)[:, :, 0] for k in range(2)])
    return X, P


@pytest.mark.parametrize("model", ["laplace", "gauss"])
def test_overiva_gauss_variant_separates(mixture52_noisy, model):
    X, P = mixture52_noisy
    Y = overiva(X, n_src=2, n_iter=30, model=model)
    ok, G = separation_success(Y, P)
    assert ok, f"OverIVA[{model}] failed: {G}"


def test_overiva_init_eig_runs(mixture52):
    X, P = mixture52
    Y = overiva(X, n_src=2, n_iter=15, init_eig=True)
    assert np.all(np.isfinite(Y))


def test_overiva_warm_start(mixture52):
    """W0 pass-through: warm-started run continues from previous filters."""
    X, P = mixture52
    Y1, W1 = overiva(X, n_src=2, n_iter=6, proj_back=False, return_filters=True)
    Y2a, W2a = overiva(X, n_src=2, n_iter=3, proj_back=False, return_filters=True)
    Y2b, W2b = overiva(
        X, n_src=2, n_iter=3, proj_back=False, W0=W2a, return_filters=True
    )
    np.testing.assert_allclose(W1, W2b, atol=1e-8)


def test_pca_projects_to_principal_subspace(rng):
    T, F, M, N = 200, 4, 4, 2
    X = rng.standard_normal((T, F, M)) + 1j * rng.standard_normal((T, F, M))
    # inflate two directions
    X[:, :, 0] *= 10
    X[:, :, 1] *= 5
    Xr, E = pca(X, N, return_basis=True)
    assert Xr.shape == (T, F, N)
    # basis columns orthonormal
    G = np.einsum("fmk,fml->fkl", np.conj(E), E)
    np.testing.assert_allclose(G, np.tile(np.eye(N), (F, 1, 1)), atol=1e-10)
    # captured variance >= any other 2-dim projection's (check vs channels 2,3)
    var_top = np.sum(np.abs(Xr) ** 2)
    var_bottom = np.sum(np.abs(X[:, :, 2:]) ** 2)
    assert var_top > var_bottom


def test_auxiva_pca_separates(mixture52):
    X, P = mixture52
    Y = auxiva_pca(X, n_src=2, n_iter=30)
    ok, G = separation_success(Y, P)
    assert ok, f"PCA+AuxIVA failed: {G}"


@pytest.mark.parametrize("update", ["demix", "mix", "switching"])
def test_ogive_extracts_dominant_source(update):
    rng = np.random.default_rng(3)
    mix, premix, src = make_mixture(rng, n_src=2, n_mics=4, n_samples=20000)
    # make source 0 clearly dominant so extraction is well-posed
    premix[0] *= 3.0
    mix = premix.sum(axis=0)
    X = stft_mixture(mix, nfft=256)
    P = np.stack([stft_mixture(premix[k], nfft=256)[:, :, 0] for k in range(2)])
    Y = ogive(X, n_iter=2000, step_size=0.05, tol=1e-4, update=update)
    assert Y.shape[2] == 1
    G = stft_sir_matrix(Y, P)
    assert G[0, 0] > 3 * G[0, 1], f"OGIVE[{update}] gain matrix {G}"


def test_ogive_early_exit():
    rng = np.random.default_rng(5)
    mix, premix, src = make_mixture(rng, n_src=1, n_mics=3, n_samples=12000)
    X = stft_mixture(mix, nfft=256)
    calls = []
    ogive(X, n_iter=4000, tol=1e-2, callback=lambda Y: calls.append(1), callback_every=1)
    # single source, generous tol -> must stop well before n_iter
    assert len(calls) < 4000


def test_callback_receives_projected_copies(mixture22):
    X, P = mixture22
    seen = []
    auxiva(X, n_iter=21, callback=lambda Y: seen.append(Y.copy()), callback_every=10)
    assert len(seen) == 3  # epochs 0, 10, 20
    for Y in seen:
        assert Y.shape == (X.shape[0], X.shape[1], 2)
        assert np.all(np.isfinite(Y))

def test_gauss_m8_no_collapse():
    """Regression (round 2): at M >> N with long-STFT few-frame data the gauss
    model used to null an output frame, blow up phi = 1/r, and NaN in f64.
    The relative activation floor (oracle/models.REL_EPS, PARITY.md row 13)
    bounds the weight dynamic range; the run must stay finite AND separate."""
    from helpers import make_mixture, stft_mixture

    rng = np.random.default_rng(77)
    mix, premix, _ = make_mixture(rng, n_src=2, n_mics=8, n_samples=24000, snr_db=25)
    X = stft_mixture(mix, nfft=2048)  # few frames, many bins: the hard regime
    P = np.stack([stft_mixture(premix[k], nfft=2048)[:, :, 0] for k in range(2)])
    Y = overiva(X, n_src=2, n_iter=30, model="gauss", init_eig=True)
    assert np.isfinite(Y).all()
    ok, G = separation_success(Y, P)
    assert ok, G
