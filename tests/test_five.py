"""FIVE (fast independent vector extraction): oracle + JAX parity."""

import numpy as np
import pytest

import overiva_jax.oracle as oracle
from overiva_jax import api

from helpers import make_mixture, stft_mixture
from test_oracle_algos import stft_sir_matrix


@pytest.fixture(scope="module")
def mixture():
    rng = np.random.default_rng(91)
    mix, premix, _ = make_mixture(rng, n_src=2, n_mics=4, n_samples=20000, snr_db=25)
    premix[0] *= 2.5  # dominant target, well-posed extraction
    mix = premix.sum(axis=0)
    X = stft_mixture(mix, nfft=256)
    P = np.stack([stft_mixture(premix[k], nfft=256)[:, :, 0] for k in range(2)])
    return X, P


def test_oracle_five_extracts_fast(mixture):
    """A handful of iterations must extract a source cleanly."""
    X, P = mixture
    Y = oracle.five(X, n_iter=6)
    G = stft_sir_matrix(Y, P)
    best = G[0].argmax()
    other = 1 - best
    assert G[0, best] > 5 * G[0, other], G


def test_five_converges_in_few_iterations(mixture):
    """FIVE's selling point: a clean extraction already at ~3 iterations
    (OGIVE needs hundreds of gradient steps for the same task; which local
    optimum each lands on can differ, so quality is asserted per-algorithm)."""
    X, P = mixture
    Y3 = oracle.five(X, n_iter=3)
    G3 = stft_sir_matrix(Y3, P)[0]
    assert G3.max() > 100 * max(G3.min(), 1e-12), G3


def test_five_jax_parity(mixture):
    X, _ = mixture
    Yo, wo = oracle.five(X, n_iter=5, return_filters=True)
    Yj, wj = api.five(X, n_iter=5, return_filters=True, dtype=np.complex128)
    # eigh backends may differ in degenerate subspaces; compare outputs
    np.testing.assert_allclose(Yj, Yo, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(wj, wo, rtol=1e-4, atol=1e-6)


def test_five_callback(mixture):
    X, _ = mixture
    snaps = []
    api.five(X, n_iter=4, callback=lambda Y: snaps.append(Y), dtype=np.complex128)
    assert len(snaps) == 4
    assert all(np.isfinite(s).all() for s in snaps)
