"""ILRMA baseline: oracle behavior + JAX parity."""

import numpy as np
import pytest

import overiva_jax.oracle.ilrma as oracle_ilrma
from overiva_jax import api

from helpers import make_mixture, stft_mixture
from test_oracle_algos import separation_success


@pytest.fixture(scope="module")
def mixture22():
    rng = np.random.default_rng(31)
    mix, premix, _ = make_mixture(rng, n_src=2, n_mics=2, n_samples=24000, snr_db=25)
    X = stft_mixture(mix, nfft=256)
    P = np.stack([stft_mixture(premix[k], nfft=256)[:, :, 0] for k in range(2)])
    return X, P


def test_oracle_ilrma_separates(mixture22):
    X, P = mixture22
    Y = oracle_ilrma.ilrma(X, n_iter=40, n_components=2)
    ok, G = separation_success(Y, P, min_ratio=5.0)
    assert ok, G


def test_ilrma_requires_determined(mixture22):
    X, _ = mixture22
    with pytest.raises(ValueError):
        oracle_ilrma.ilrma(X, n_src=1)
    with pytest.raises(ValueError):
        api.ilrma(X, n_src=1)


def test_ilrma_jax_parity(mixture22):
    X, P = mixture22
    Yo, Wo = oracle_ilrma.ilrma(X, n_iter=8, return_filters=True, seed=3)
    Yj, Wj = api.ilrma(X, n_iter=8, return_filters=True, seed=3, dtype=np.complex128)
    np.testing.assert_allclose(Wj, Wo, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(Yj, Yo, rtol=1e-6, atol=1e-9)


def test_ilrma_jax_separates(mixture22):
    X, P = mixture22
    Y = api.ilrma(X, n_iter=40)
    ok, G = separation_success(Y, P, min_ratio=5.0)
    assert ok, G


def test_ilrma_callback_cadence(mixture22):
    X, _ = mixture22
    snaps = []
    api.ilrma(X, n_iter=21, callback=lambda Y: snaps.append(Y), dtype=np.complex128)
    assert len(snaps) == 3
