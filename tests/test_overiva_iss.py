"""OverIVA-ISS (overdetermined rank-1 source steering): oracle behavior,
degeneracy to AuxIVA-ISS at N == M, JAX parity, quality vs OverIVA-IP, and
the sharded path (oracle derivation: overiva_jax/oracle/overiva_iss.py)."""

import numpy as np
import pytest

import overiva_jax.oracle as oracle
from overiva_jax import api

from helpers import make_mixture, stft_mixture
from test_oracle_algos import separation_success


@pytest.fixture(scope="module")
def mixture52():
    rng = np.random.default_rng(91)
    mix, premix, _ = make_mixture(rng, n_src=2, n_mics=5, n_samples=20000, snr_db=25)
    X = stft_mixture(mix, nfft=256)
    P = np.stack([stft_mixture(premix[k], nfft=256)[:, :, 0] for k in range(2)])
    return X, P


@pytest.mark.parametrize("model", ["laplace", "gauss"])
def test_oracle_overiva_iss_separates(mixture52, model):
    X, P = mixture52
    Y = oracle.overiva_iss(X, n_src=2, n_iter=30, model=model)
    assert Y.shape[2] == 2
    ok, G = separation_success(Y, P)
    assert ok, G


def test_degenerates_to_auxiva_iss(mixture52):
    """N == M: exactly the determined ISS trajectory."""
    X, _ = mixture52
    Yo = oracle.auxiva_iss(X, n_iter=8)
    Yi = oracle.overiva_iss(X, n_src=X.shape[2], n_iter=8)
    np.testing.assert_allclose(Yi, Yo, rtol=1e-12, atol=1e-12)


def test_quality_comparable_to_overiva_ip(mixture52):
    """Same MM objective as OverIVA-IP: both must separate this mixture."""
    X, P = mixture52
    Yip = oracle.overiva(X, n_src=2, n_iter=30)
    Yiss = oracle.overiva_iss(X, n_src=2, n_iter=30)
    ok_ip, _ = separation_success(Yip, P)
    ok_iss, G = separation_success(Yiss, P)
    assert ok_ip and ok_iss, G


def test_background_unit_power(mixture52):
    """The background self-update drives each extra output to unit per-bin
    power (the ISS form of the stationary-Gaussian background model)."""
    X, _ = mixture52
    _, W = oracle.overiva_iss(X, n_src=2, n_iter=40, return_filters=True)
    Yfull = np.einsum("fnm,tfm->tfn", W, X)
    pw = np.mean(np.abs(Yfull[:, :, 2:]) ** 2, axis=0)  # (F, M-N)
    np.testing.assert_allclose(pw, 1.0, atol=0.15)


def test_overiva_iss_jax_parity(mixture52):
    X, _ = mixture52
    Yo, Wo = oracle.overiva_iss(X, n_src=2, n_iter=10, return_filters=True)
    Yj, Wj = api.overiva_iss(
        X, n_src=2, n_iter=10, return_filters=True, dtype=np.complex128
    )
    np.testing.assert_allclose(Wj, Wo, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(Yj, Yo, rtol=1e-6, atol=1e-8)


def test_overiva_iss_callback_parity(mixture52):
    X, _ = mixture52
    so, sj = [], []
    oracle.overiva_iss(X, n_src=2, n_iter=21, callback=lambda Y: so.append(Y.copy()))
    api.overiva_iss(
        X, n_src=2, n_iter=21, callback=lambda Y: sj.append(Y),
        dtype=np.complex128,
    )
    assert len(so) == len(sj) == 3
    for a, b in zip(so, sj):
        assert a.shape[2] == 2
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-8)


def test_overiva_iss_w0_roundtrip(mixture52):
    X, _ = mixture52
    Y1, W1 = oracle.overiva_iss(
        X, n_src=2, n_iter=6, proj_back=False, return_filters=True
    )
    Yj = api.overiva_iss(
        X, n_src=2, n_iter=0, W0=W1, proj_back=False, dtype=np.complex128
    )
    Yref = np.einsum("fnm,tfm->tfn", W1, X)[:, :, :2]
    np.testing.assert_allclose(Yj, Yref, rtol=1e-8, atol=1e-10)


def test_overiva_iss_registry():
    from overiva_jax.registry import applicable, get_algorithm

    spec = get_algorithm("overiva-iss")
    assert applicable("overiva-iss", 2, 5)
    assert not applicable("overiva-iss", 5, 2)
    rng = np.random.default_rng(92)
    mix, premix, _ = make_mixture(rng, n_src=2, n_mics=4, n_samples=12000, snr_db=25)
    X = stft_mixture(mix, nfft=128)
    Y = spec(X, n_src=2, n_iter=5)
    assert Y.shape == (X.shape[0], X.shape[1], 2)
    assert np.isfinite(Y).all()


def test_sharded_overiva_iss_matches_single_device(mixture52):
    import jax

    from overiva_jax.parallel.mesh import make_mesh
    from overiva_jax.parallel.sharded import sharded_overiva_iss

    X, _ = mixture52
    Xs = X[:40].astype(np.complex64)
    n_bins = min(4, len(jax.devices()))
    mesh = make_mesh(1, n_bins, devices=jax.devices()[:n_bins])
    Yb = np.asarray(
        jax.jit(lambda x: x)(
            sharded_overiva_iss(mesh, Xs[None], n_src=2, n_iter=4)
        )
    )
    Yref = api.overiva_iss(Xs, n_src=2, n_iter=4, dtype=np.complex64)
    np.testing.assert_allclose(Yb[0], Yref, rtol=2e-3, atol=2e-4)


def test_overiva_iss_parity_gate(mixture52):
    """End-to-end 0.1 dB SDR/SIR gate vs the oracle (BASELINE.json:2)."""
    from test_integration import parity_case

    rng = np.random.default_rng(93)
    mix, premix, _ = make_mixture(rng, n_src=2, n_mics=5, n_samples=24000, snr_db=25)
    sdr, sir = parity_case(
        mix, premix,
        lambda X: oracle.overiva_iss(X, n_src=2, n_iter=20),
        lambda X: api.overiva_iss(X, n_src=2, n_iter=20),
        nfft=256,
    )
    assert np.min(sir) > 8.0, sir
