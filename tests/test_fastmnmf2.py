"""FastMNMF2: likelihood monotonicity, separation quality, oracle parity.

The update equations are reconstructed from the published FastMNMF2 MM
derivation (Sekiguchi et al. 2020; no reference source available —
PARITY.md row 15). Monotone non-decrease of the EXACT log-likelihood
after every epoch is the correctness anchor: each sub-update (W, H, g,
Q rows, normalization) is an MM step or a reparametrization, so any
equation error shows up as a likelihood drop.
"""

import numpy as np
import pytest

from overiva_jax import api
from overiva_jax.metrics import BssEvalReferences
from overiva_jax.oracle import synthesis
from overiva_jax.oracle.fastmnmf2 import fastmnmf, fastmnmf2, fastmnmf2_loglik
from overiva_jax.registry import applicable, get_algorithm

from helpers import make_mixture, stft_mixture


@pytest.fixture(scope="module")
def mixture32():
    rng = np.random.default_rng(11)
    mix, premix, src = make_mixture(
        rng, n_src=2, n_mics=3, n_samples=24000, n_taps=8, snr_db=25
    )
    X = stft_mixture(mix, 512)
    return mix, premix, X


def test_oracle_loglik_monotone(mixture32):
    _, _, X = mixture32
    lls = []
    for it in range(9):
        _, params = fastmnmf2(X, n_src=2, n_iter=it, seed=5, return_filters=True)
        lls.append(fastmnmf2_loglik(X, *params))
    diffs = np.diff(lls)
    assert np.all(diffs >= -1e-6 * np.abs(np.asarray(lls[:-1]))), lls


def test_oracle_normalization_is_reparametrization(mixture32):
    """The per-epoch rescaling must not move the likelihood: the parameters
    after normalize describe the same model."""
    _, _, X = mixture32
    _, (Q, g, W, H) = fastmnmf2(X, n_src=2, n_iter=4, seed=5, return_filters=True)
    ll = fastmnmf2_loglik(X, Q, g, W, H)
    # re-apply the (likelihood-invariant) normalization by hand
    M = Q.shape[1]
    phi = np.real(np.einsum("fmn,fmn->f", Q, np.conj(Q))) / M
    ll2 = fastmnmf2_loglik(
        X, Q / np.sqrt(phi)[:, None, None], g, W / phi[None, :, None], H
    )
    np.testing.assert_allclose(ll, ll2, rtol=1e-9)


def test_oracle_separates(mixture32):
    mix, premix, X = mixture32
    Y = fastmnmf2(X, n_src=2, n_iter=40, seed=5)
    y = synthesis(Y, 512, 256)[256:][: mix.shape[0]]
    ev = BssEvalReferences(premix[:, :, 0])
    _, sir_mix, _, _ = ev.evaluate(np.tile(mix[:, 0], (2, 1)))
    _, sir, _, _ = ev.evaluate(y.T)
    assert sir.mean() > sir_mix.mean() + 10, (sir_mix, sir)
    assert sir.mean() > 12


def test_jax_matches_oracle(mixture32):
    """Same init, 12 epochs: SDR/SIR parity within the 0.1 dB gate."""
    mix, premix, X = mixture32
    ev = BssEvalReferences(premix[:, :, 0])

    def score(Y):
        y = synthesis(np.asarray(Y, dtype=np.complex128), 512, 256)
        y = y[256:][: mix.shape[0]]
        sdr, sir, _, _ = ev.evaluate(y.T)
        return sdr, sir

    sdr_o, sir_o = score(fastmnmf2(X, n_src=2, n_iter=12, seed=5))
    sdr_j, sir_j = score(api.fastmnmf2(X, n_src=2, n_iter=12, seed=5))
    assert np.abs(sdr_j - sdr_o).max() < 0.1, (sdr_o, sdr_j)
    assert np.abs(sir_j - sir_o).max() < 0.1, (sir_o, sir_j)


def test_jax_filters_match_oracle(mixture32):
    """Trajectory-level check: parameters agree after a few epochs."""
    _, _, X = mixture32
    _, p_o = fastmnmf2(X, n_src=2, n_iter=5, seed=5, return_filters=True)
    _, p_j = api.fastmnmf2(X, n_src=2, n_iter=5, seed=5, return_filters=True)
    for name, a, b in zip("QgWH", p_o, p_j):
        a = np.asarray(a)
        b = np.asarray(b, dtype=a.dtype)
        scale = np.abs(a).max()
        assert np.abs(a - b).max() < 5e-3 * scale, name


def test_overdetermined_and_callback(mixture32):
    """n_src < n_chan works; callback receives (T, F, n_src) snapshots."""
    _, _, X = mixture32
    seen = []
    Y = api.fastmnmf2(
        X, n_src=2, n_iter=6, seed=1, callback=lambda y: seen.append(y.shape),
        callback_every=3,
    )
    assert Y.shape == (X.shape[0], X.shape[1], 2)
    assert seen == [(X.shape[0], X.shape[1], 2)] * 2


def test_wiener_images_sum_to_mixture(mixture32):
    """sum_n gain_n = D/D = 1, so the full-model Wiener images must
    reconstruct the reference-mic signal EXACTLY (linear identity, holds
    at any parameter values — a sharp check of the separation filter)."""
    _, _, X = mixture32
    Y, (Q, g, W, H) = fastmnmf2(
        X, n_src=3, n_iter=3, seed=2, n_noise=0, return_filters=True
    )
    np.testing.assert_allclose(Y.sum(axis=2), X[:, :, 0], rtol=1e-8, atol=1e-10)

    import jax.numpy as jnp

    from overiva_jax.models.fastmnmf2 import fastmnmf2_wiener

    Yj = np.asarray(
        fastmnmf2_wiener(
            jnp.asarray(X), jnp.asarray(Q), jnp.asarray(g), jnp.asarray(W),
            jnp.asarray(H), 0,
        )
    )
    np.testing.assert_allclose(Yj.sum(axis=2), X[:, :, 0], rtol=1e-6, atol=1e-8)


def test_fastmnmf1_loglik_monotone_and_above_tied(mixture32):
    """FastMNMF1 (untied per-frequency g): every epoch is still an MM step
    on the exact likelihood, and the extra spatial freedom can only raise
    the attained likelihood relative to the tied model at the same epoch
    count (both start from the same tied init)."""
    _, _, X = mixture32
    lls, lls2 = [], []
    for it in range(6):
        _, p1 = fastmnmf(X, n_src=2, n_iter=it, seed=5, return_filters=True)
        _, p2 = fastmnmf2(X, n_src=2, n_iter=it, seed=5, return_filters=True)
        lls.append(fastmnmf2_loglik(X, *p1))
        lls2.append(fastmnmf2_loglik(X, *p2))
    diffs = np.diff(lls)
    assert np.all(diffs >= -1e-6 * np.abs(np.asarray(lls[:-1]))), lls
    assert p1[1].shape == (3, X.shape[1], X.shape[2])  # untied g (N, F, M)
    assert np.all(np.asarray(lls[1:]) >= np.asarray(lls2[1:]) - 1e-6), (
        lls, lls2)


def test_q_sweeps_monotone_and_dominant(mixture32):
    """n_q_sweeps=2: still monotone (extra sweeps optimize the SAME MM
    surrogate — V_m depends only on the epoch-fixed weights 1/D), attains
    >= the 1-sweep likelihood at equal epochs, and the JAX twin tracks
    the oracle."""
    _, _, X = mixture32
    lls = []
    for it in range(6):
        _, p = fastmnmf2(
            X, n_src=2, n_iter=it, seed=5, n_q_sweeps=2, return_filters=True
        )
        lls.append(fastmnmf2_loglik(X, *p))
    assert np.all(np.diff(lls) >= -1e-6 * np.abs(np.asarray(lls[:-1]))), lls
    _, p1 = fastmnmf2(X, n_src=2, n_iter=5, seed=5, return_filters=True)
    assert lls[5] >= fastmnmf2_loglik(X, *p1) - 1e-6

    _, p_j = api.fastmnmf2(
        X, n_src=2, n_iter=5, seed=5, n_q_sweeps=2, return_filters=True
    )
    for name, a, b in zip("QgWH", p, p_j):
        a = np.asarray(a)
        b = np.asarray(b, dtype=a.dtype)
        assert np.abs(a - b).max() < 5e-3 * np.abs(a).max(), name


def test_fastmnmf1_jax_matches_oracle(mixture32):
    """Same init, 12 epochs: SDR/SIR parity within the 0.1 dB gate."""
    mix, premix, X = mixture32
    ev = BssEvalReferences(premix[:, :, 0])

    def score(Y):
        y = synthesis(np.asarray(Y, dtype=np.complex128), 512, 256)
        y = y[256:][: mix.shape[0]]
        sdr, sir, _, _ = ev.evaluate(y.T)
        return sdr, sir

    sdr_o, sir_o = score(fastmnmf(X, n_src=2, n_iter=12, seed=5))
    sdr_j, sir_j = score(api.fastmnmf(X, n_src=2, n_iter=12, seed=5))
    assert np.abs(sdr_j - sdr_o).max() < 0.1, (sdr_o, sdr_j)
    assert np.abs(sir_j - sir_o).max() < 0.1, (sir_o, sir_j)
    assert sir_j.mean() > 12


def test_fastmnmf1_batch_matches_single(mixture32):
    _, _, X = mixture32
    Xb = np.stack([X, 0.5 * X])
    Yb = api.fastmnmf_batch(Xb, n_src=2, n_iter=4, seed=5)
    Y0 = api.fastmnmf(X, n_src=2, n_iter=4, seed=5)
    assert Yb.shape == (2,) + Y0.shape
    np.testing.assert_allclose(Yb[0], Y0, rtol=2e-4, atol=2e-6)


def test_long_horizon_f32_stays_finite(mixture32):
    """Regression net for the D floor (_D_FLOOR=1e-7): 120 f32 epochs on
    a small mixture must stay finite. Before the floor, the IS weights
    y/D^2 overflowed pure-f32 statistic sums at 60+ epochs (the NumPy
    oracle masked it by promoting D/S1/S2 to float64); see PARITY.md
    behavioral notes for the full regime characterization."""
    _, _, X = mixture32
    Y, (Q, g, W, H) = api.fastmnmf2(
        X, n_src=2, n_iter=120, seed=3, return_filters=True,
        dtype=np.complex64,
    )
    for name, arr in (("Y", Y), ("Q", Q), ("g", g), ("W", W), ("H", H)):
        assert np.isfinite(arr).all(), name


def test_registry_entry(mixture32):
    _, _, X = mixture32
    assert applicable("fastmnmf2", 2, 3)
    assert applicable("fastmnmf2", 3, 3)
    assert applicable("fastmnmf", 2, 3)
    Y = get_algorithm("fastmnmf2")(X, n_src=2, n_iter=2)
    assert Y.shape[2] == 2
    Y = get_algorithm("fastmnmf")(X, n_src=2, n_iter=2)
    assert Y.shape[2] == 2


def test_validation():
    X = np.zeros((8, 5, 2), dtype=np.complex64)
    with pytest.raises(ValueError):
        api.fastmnmf2(X, n_src=0)


def test_starved_frames_guard_warns(rng):
    # PARITY.md regime boundary: T < ~150 with n_iter > 60 is the measured
    # overfit/collapse zone -> the API must warn
    import warnings

    from overiva_jax import api

    X = (rng.standard_normal((40, 9, 3))
         + 1j * rng.standard_normal((40, 9, 3))).astype(np.complex64)
    with pytest.warns(UserWarning, match="safe regime"):
        api.fastmnmf2(X, n_src=2, n_iter=61, seed=1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        api.fastmnmf2(X, n_src=2, n_iter=5, seed=1)  # safe zone: no warning
