"""ILRMA-T (joint dereverberation + ILRMA via T-ISS steering): exact
likelihood monotonicity, separation, JAX parity, batch/sharded consistency
(derivation: overiva_jax/oracle/ilrma_t.py)."""

import numpy as np
import pytest

from overiva_jax import api
from overiva_jax.oracle.ilrma_t import ilrma_t, ilrma_t_loglik

from helpers import make_mixture, stft_mixture
from test_oracle_algos import separation_success


@pytest.fixture(scope="module")
def mixture22():
    rng = np.random.default_rng(31)
    mix, premix, _ = make_mixture(rng, n_src=2, n_mics=2, n_samples=24000, snr_db=25)
    X = stft_mixture(mix, nfft=256).astype(np.complex128)
    P = np.stack([stft_mixture(premix[k], nfft=256)[:, :, 0] for k in range(2)])
    return X, P


@pytest.fixture(scope="module")
def mixture23_small():
    rng = np.random.default_rng(37)
    mix, _, _ = make_mixture(
        rng, n_src=2, n_mics=2, n_samples=12000, n_taps=150, snr_db=25
    )
    return stft_mixture(mix, nfft=128).astype(np.complex128)


def test_oracle_loglik_monotone(mixture23_small):
    """Every step is an exact coordinate minimizer of the ILRMA-T MM
    surrogate (and the renormalization is likelihood-invariant), so the
    exact negative log-likelihood descends each epoch."""
    X = mixture23_small
    taps, delay = 3, 2
    lls = []
    for n in range(1, 7):
        _, P, (B, H) = ilrma_t(
            X, taps=taps, delay=delay, n_iter=n, proj_back=False,
            return_filters=True, return_nmf=True, seed=1,
        )
        lls.append(ilrma_t_loglik(X, P, B, H, taps, delay))
    assert all(lls[i + 1] <= lls[i] + 1e-6 for i in range(len(lls) - 1)), lls


def test_oracle_separates(mixture22):
    """Both ILRMA-ISS (taps=0) and ILRMA-T separate the standard ILRMA
    scene (same gate as tests/test_ilrma.py)."""
    X, P = mixture22
    ok0, G0 = separation_success(
        ilrma_t(X, taps=0, n_iter=40, seed=0), P, min_ratio=5.0
    )
    assert ok0, G0
    ok, G = separation_success(
        ilrma_t(X, taps=3, delay=2, n_iter=40, seed=0), P, min_ratio=5.0
    )
    assert ok, G


def test_jax_parity_c128(mixture23_small):
    X = mixture23_small
    Yo, Po = ilrma_t(
        X, taps=3, delay=2, n_iter=8, return_filters=True, seed=3
    )
    Yj, Pj = api.ilrma_t(
        X, taps=3, delay=2, n_iter=8, return_filters=True, seed=3,
        dtype=np.complex128,
    )
    np.testing.assert_allclose(Pj, Po, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(Yj, Yo, rtol=1e-6, atol=1e-8)


def test_validation_and_callback(mixture23_small):
    X = mixture23_small
    with pytest.raises(ValueError):
        api.ilrma_t(X, n_src=1)
    with pytest.raises(ValueError):
        api.ilrma_t(X, taps=2, delay=0)
    snaps = []
    api.ilrma_t(
        X, taps=2, delay=1, n_iter=11, callback=lambda Y: snaps.append(Y),
        callback_every=5, dtype=np.complex128, seed=3,
    )
    assert len(snaps) == 3


def test_batch_matches_single(mixture23_small):
    X = mixture23_small
    Xb = np.stack([X, 0.8 * X])
    Yb = api.ilrma_t_batch(
        Xb, taps=2, delay=1, n_iter=5, seed=9, dtype=np.complex128
    )
    for b, scale in enumerate((1.0, 0.8)):
        Yref = api.ilrma_t(
            scale * X, taps=2, delay=1, n_iter=5, seed=9 + b,
            dtype=np.complex128,
        )
        np.testing.assert_allclose(Yb[b], Yref, rtol=1e-8, atol=1e-10)


def test_registry():
    from overiva_jax.registry import applicable, get_algorithm

    spec = get_algorithm("ilrma-t")
    assert applicable("ilrma-t", 2, 2) and not applicable("ilrma-t", 2, 3)
    rng = np.random.default_rng(43)
    mix, _, _ = make_mixture(rng, n_src=2, n_mics=2, n_samples=10000, snr_db=25)
    X = stft_mixture(mix, nfft=128)
    Y = spec(X, n_src=2, n_iter=4)
    assert Y.shape == X.shape and np.isfinite(Y).all()


def test_sharded_matches_single_device(mixture23_small):
    import jax

    from overiva_jax.parallel.mesh import make_mesh
    from overiva_jax.parallel.sharded import sharded_ilrma_t

    X = mixture23_small[:40].astype(np.complex64)
    n_bins = min(4, len(jax.devices()))
    mesh = make_mesh(1, n_bins, devices=jax.devices()[:n_bins])
    Yb = np.asarray(
        sharded_ilrma_t(mesh, X[None], taps=2, delay=1, n_iter=4, seed=5)
    )
    Yref = api.ilrma_t(
        X, taps=2, delay=1, n_iter=4, seed=5, dtype=np.complex64
    )
    np.testing.assert_allclose(Yb[0], Yref, rtol=2e-3, atol=2e-4)
