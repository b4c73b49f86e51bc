"""AuxIVA-IP2 / OverIVA-IP2 (pairwise joint updates): derivation invariants
(surrogate descent, IP1 fixed-point preservation), convergence-speed claim,
JAX parity, and the 0.1 dB end-to-end gate."""

import numpy as np
import pytest

import overiva_jax.oracle as oracle
from overiva_jax import api
from overiva_jax.oracle.models import activations

from helpers import make_mixture, stft_mixture
from test_oracle_algos import separation_success


def surrogate_cost(W, X, model="laplace"):
    """The MM objective sum_k E[G(r_k)] - 2 log|det W| (laplace: G(r) = r)."""
    Y = np.einsum("fnm,tfm->tfn", W, X)
    r, _ = activations(Y, model)
    _, logdet = np.linalg.slogdet(W)
    return float(np.sum(np.mean(r, axis=0)) - 2 * np.sum(logdet))


@pytest.fixture(scope="module")
def mixture33():
    rng = np.random.default_rng(55)
    mix, premix, _ = make_mixture(rng, n_src=3, n_mics=3, n_samples=20000, snr_db=25)
    X = stft_mixture(mix, nfft=256).astype(np.complex128)
    P = np.stack([stft_mixture(premix[k], nfft=256)[:, :, 0] for k in range(3)])
    return X, P


@pytest.fixture(scope="module")
def mixture52():
    rng = np.random.default_rng(56)
    mix, premix, _ = make_mixture(rng, n_src=2, n_mics=5, n_samples=20000, snr_db=25)
    X = stft_mixture(mix, nfft=256)
    P = np.stack([stft_mixture(premix[k], nfft=256)[:, :, 0] for k in range(2)])
    return X, P


def test_surrogate_monotone_descent(mixture33):
    """Each IP2 epoch must not increase the MM objective."""
    X, _ = mixture33
    costs = []
    cb = lambda Y: None
    W = None
    for n in range(1, 7):
        _, Wn = oracle.auxiva_ip2(X, n_iter=n, proj_back=False, return_filters=True)
        costs.append(surrogate_cost(Wn, X))
    assert all(costs[k + 1] <= costs[k] + 1e-6 for k in range(len(costs) - 1)), costs


def test_ip1_fixed_point_preserved(mixture33):
    """A converged IP1 solution is a fixed point of the IP2 update (up to a
    per-row phase; the objective must not change)."""
    X, _ = mixture33
    _, W1 = oracle.auxiva(X, n_iter=40, proj_back=False, return_filters=True)
    c1 = surrogate_cost(W1, X)
    _, W2 = oracle.auxiva_ip2(
        X, n_iter=1, W0=W1, proj_back=False, return_filters=True
    )
    c2 = surrogate_cost(W2, X)
    assert abs(c2 - c1) < 1e-3 * abs(c1), (c1, c2)
    # rows unchanged up to phase: |<w1, w2>| == |w1||w2| per row/bin
    dot = np.abs(np.sum(W2 * np.conj(W1), axis=2))
    norms = np.linalg.norm(W1, axis=2) * np.linalg.norm(W2, axis=2)
    np.testing.assert_allclose(dot, norms, rtol=1e-5)


def test_ip2_converges_faster_than_ip1(mixture33):
    """The Faster-IVA claim: at 4 epochs IP2 separates, IP1 does not yet."""
    X, P = mixture33
    Y2 = oracle.auxiva_ip2(X, n_iter=4)
    ok2, G2 = separation_success(Y2, P)
    assert ok2, G2
    Y1 = oracle.auxiva(X, n_iter=4)
    ok1, _ = separation_success(Y1, P)
    assert not ok1  # IP1 needs ~15 epochs on this mixture


def test_overdetermined_ip2_oracle(mixture52):
    X, P = mixture52
    Y = oracle.overiva_ip2(np.asarray(X, np.complex128), n_src=2, n_iter=6)
    assert Y.shape[2] == 2
    ok, G = separation_success(Y, P)
    assert ok, G


def test_ip2_validates():
    X = np.zeros((10, 9, 3), np.complex128)
    with pytest.raises(ValueError):
        oracle.overiva_ip2(X, n_src=1)
    with pytest.raises(ValueError):
        api.overiva_ip2(X, n_src=1)
    with pytest.raises(ValueError):
        api.auxiva_ip2(X, n_src=2)


def test_ip2_jax_parity(mixture33):
    """Trajectory parity: identical closed-form GEVD in both backends."""
    X, _ = mixture33
    Yo, Wo = oracle.auxiva_ip2(X, n_iter=6, return_filters=True)
    Yj, Wj = api.auxiva_ip2(X, n_iter=6, return_filters=True, dtype=np.complex128)
    np.testing.assert_allclose(Wj, Wo, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(Yj, Yo, rtol=1e-6, atol=1e-8)


def test_ip2_overdetermined_jax_parity(mixture52):
    X, _ = mixture52
    X = np.asarray(X, np.complex128)
    Yo, Wo = oracle.overiva_ip2(X, n_src=2, n_iter=6, return_filters=True)
    Yj, Wj = api.overiva_ip2(X, n_src=2, n_iter=6, return_filters=True,
                             dtype=np.complex128)
    np.testing.assert_allclose(Wj, Wo, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(Yj, Yo, rtol=1e-6, atol=1e-8)


def test_ip2_callback_parity(mixture52):
    X, _ = mixture52
    so, sj = [], []
    oracle.overiva_ip2(
        np.asarray(X, np.complex128), n_src=2, n_iter=11,
        callback=lambda Y: so.append(Y.copy()),
    )
    api.overiva_ip2(
        X, n_src=2, n_iter=11, callback=lambda Y: sj.append(Y),
        dtype=np.complex128,
    )
    assert len(so) == len(sj) == 2
    for a, b in zip(so, sj):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-8)


def test_ip2_parity_gate_end_to_end():
    """The 0.1 dB SDR/SIR gate (complex64 JAX vs float64 oracle)."""
    from test_integration import parity_case

    rng = np.random.default_rng(57)
    mix, premix, _ = make_mixture(rng, n_src=2, n_mics=5, n_samples=24000, snr_db=25)
    sdr, sir = parity_case(
        mix, premix,
        lambda X: oracle.overiva_ip2(np.asarray(X, np.complex128), n_src=2, n_iter=8),
        lambda X: api.overiva_ip2(X, n_src=2, n_iter=8),
        nfft=256,
    )
    assert np.min(sir) > 8.0, sir


def test_ip2_registry():
    from overiva_jax.registry import applicable

    assert applicable("overiva-ip2", 2, 5)
    assert applicable("overiva-ip2", 3, 3)
    assert not applicable("overiva-ip2", 1, 5)


def test_ip2_batch_matches_loop(mixture52):
    X, _ = mixture52
    batch = np.stack([X[:60], X[30:90]]).astype(np.complex128)
    Yb = api.overiva_ip2_batch(batch, n_src=2, n_iter=5, dtype=np.complex128)
    assert Yb.shape == batch.shape[:3] + (2,)
    for b in range(2):
        Yref = api.overiva_ip2(batch[b], n_src=2, n_iter=5, dtype=np.complex128)
        np.testing.assert_allclose(Yb[b], Yref, rtol=1e-7, atol=1e-9)


def test_ip2_fused_serving_path(mixture52):
    from helpers import make_mixture as _mm

    rng = np.random.default_rng(58)
    mix, _, _ = _mm(rng, n_src=2, n_mics=4, n_samples=16000, snr_db=25)
    y = api.separate(mix, n_src=2, nfft=256, n_iter=5, algo="ip2",
                     dtype=np.complex128)
    assert y.shape == (mix.shape[0], 2) and np.isfinite(y).all()
    with pytest.raises(ValueError):
        api.separate(mix, n_src=1, algo="ip2")


def test_sharded_ip2_matches_single_device(mixture52):
    import jax

    from overiva_jax.parallel.mesh import make_mesh
    from overiva_jax.parallel.sharded import sharded_overiva_ip2

    X, _ = mixture52
    Xs = np.asarray(X[:40], np.complex64)
    n_bins = min(4, len(jax.devices()))
    mesh = make_mesh(1, n_bins, devices=jax.devices()[:n_bins])
    Yb = np.asarray(
        jax.jit(lambda x: x)(
            sharded_overiva_ip2(mesh, Xs[None], n_src=2, n_iter=3)
        )
    )
    Yref = api.overiva_ip2(Xs, n_src=2, n_iter=3, dtype=np.complex64)
    np.testing.assert_allclose(Yb[0], Yref, rtol=2e-3, atol=2e-4)
