"""AuxIVA-ISS (rank-1 source steering): oracle behavior + JAX parity."""

import numpy as np
import pytest

import overiva_jax.oracle as oracle
from overiva_jax import api

from helpers import make_mixture, stft_mixture
from test_oracle_algos import separation_success


@pytest.fixture(scope="module")
def mixture22():
    rng = np.random.default_rng(81)
    mix, premix, _ = make_mixture(rng, n_src=2, n_mics=2, n_samples=20000, snr_db=25)
    X = stft_mixture(mix, nfft=256)
    P = np.stack([stft_mixture(premix[k], nfft=256)[:, :, 0] for k in range(2)])
    return X, P


@pytest.mark.parametrize("model", ["laplace", "gauss"])
def test_oracle_iss_separates(mixture22, model):
    X, P = mixture22
    Y = oracle.auxiva_iss(X, n_iter=30, model=model)
    ok, G = separation_success(Y, P)
    assert ok, G


def test_iss_agrees_with_ip_quality(mixture22):
    """ISS and IP minimize the same auxiliary function: comparable quality."""
    X, P = mixture22
    Yip = oracle.auxiva(X, n_iter=30)
    Yiss = oracle.auxiva_iss(X, n_iter=30)
    ok_ip, Gip = separation_success(Yip, P)
    ok_iss, Giss = separation_success(Yiss, P)
    assert ok_ip and ok_iss


def test_iss_determined_only(mixture22):
    X, _ = mixture22
    with pytest.raises(ValueError):
        oracle.auxiva_iss(X, n_src=1)
    with pytest.raises(ValueError):
        api.auxiva_iss(X, n_src=1)


def test_iss_jax_parity(mixture22):
    X, _ = mixture22
    Yo, Wo = oracle.auxiva_iss(X, n_iter=10, return_filters=True)
    Yj, Wj = api.auxiva_iss(X, n_iter=10, return_filters=True, dtype=np.complex128)
    np.testing.assert_allclose(Wj, Wo, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(Yj, Yo, rtol=1e-6, atol=1e-8)


def test_iss_callback_parity(mixture22):
    X, _ = mixture22
    so, sj = [], []
    oracle.auxiva_iss(X, n_iter=21, callback=lambda Y: so.append(Y.copy()))
    api.auxiva_iss(X, n_iter=21, callback=lambda Y: sj.append(Y), dtype=np.complex128)
    assert len(so) == len(sj) == 3
    for a, b in zip(so, sj):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-8)


def test_pca_iss_separates():
    rng = np.random.default_rng(82)
    mix, premix, _ = make_mixture(rng, n_src=2, n_mics=5, n_samples=20000, snr_db=25)
    X = stft_mixture(mix, nfft=256)
    P = np.stack([stft_mixture(premix[k], nfft=256)[:, :, 0] for k in range(2)])
    Y = api.auxiva_pca(X, n_src=2, n_iter=30, inner="iss")
    ok, G = separation_success(Y, P)
    assert ok, G


def test_iss_w0_roundtrip(mixture22):
    X, _ = mixture22
    Y1, W1 = oracle.auxiva_iss(X, n_iter=6, proj_back=False, return_filters=True)
    Yj = api.auxiva_iss(X, n_iter=0, W0=W1, proj_back=False, dtype=np.complex128)
    Yref = np.einsum("fnm,tfm->tfn", W1, X)
    np.testing.assert_allclose(Yj, Yref, rtol=1e-8, atol=1e-10)
