"""acc="f32x2" (double-float) OverIVA/AuxIVA vs the float64 oracle.

The equivalence target is the round-4 variant-F experiment
(bench/exp_gauss_floor.py, PARITY.md): the f64 oracle run on the
c64-quantized input IS the reference trajectory; the df path must
reproduce it to ~2^-45-level element-wise deltas (far below the 0.1 dB
quality gate — the chaotic amplification that makes c64 drift 0.1 dB has
~2^-24x less seed to work with).
"""

import numpy as np
import pytest

from overiva_jax import api, oracle


@pytest.fixture
def mixture(rng):
    T, F, M, N = 60, 17, 4, 2
    S = rng.standard_normal((T, F, N)) + 1j * rng.standard_normal((T, F, N))
    A = rng.standard_normal((F, M, N)) + 1j * rng.standard_normal((F, M, N))
    X = np.einsum("fmn,tfn->tfm", A, S)
    X += 0.01 * (rng.standard_normal(X.shape) + 1j * rng.standard_normal(X.shape))
    return X.astype(np.complex64)


@pytest.mark.parametrize("model", ["gauss", "laplace"])
def test_df_matches_f64_oracle_overdetermined(mixture, model):
    Xc = mixture
    Y = api.overiva(Xc, n_src=2, n_iter=8, model=model, acc="f32x2")
    Yo = oracle.overiva(
        Xc.astype(np.complex128), n_src=2, n_iter=8, model=model
    )
    scale = np.abs(Yo).max()
    assert np.abs(Y - Yo).max() / scale < 1e-6


def test_df_matches_f64_oracle_determined(mixture):
    Xc = mixture[:, :, :2]
    Y = api.auxiva(Xc, n_iter=8, model="gauss", acc="f32x2")
    Yo = oracle.auxiva(Xc.astype(np.complex128), n_iter=8, model="gauss")
    assert np.abs(Y - Yo).max() / np.abs(Yo).max() < 1e-6


def test_df_w0_and_filters(mixture):
    Xc = mixture
    # warm start from the f32 path's filters, get filters back
    _, W0 = api.overiva(Xc, n_src=2, n_iter=2, return_filters=True)
    Y, W = api.overiva(
        Xc, n_src=2, n_iter=3, W0=W0, acc="f32x2", return_filters=True
    )
    Yo, Wo = oracle.overiva(
        Xc.astype(np.complex128), n_src=2, n_iter=3,
        W0=W0.astype(np.complex128), return_filters=True,
    )
    assert np.abs(Y - Yo).max() / np.abs(Yo).max() < 1e-6
    assert np.abs(W - Wo).max() / np.abs(Wo).max() < 1e-6


def test_df_callback_cadence(mixture):
    snaps = []
    api.overiva(
        mixture, n_src=2, n_iter=5, acc="f32x2",
        callback=lambda y: snaps.append(np.abs(y).mean()), callback_every=2,
    )
    assert len(snaps) == 3  # epochs 0, 2, 4 — reference cadence
    assert all(np.isfinite(s) for s in snaps)


def test_df_rejects_init_eig(mixture):
    with pytest.raises(ValueError, match="init_eig"):
        api.overiva(mixture, n_src=2, acc="f32x2", init_eig=True)
    with pytest.raises(ValueError, match="acc"):
        api.overiva(mixture, n_src=2, acc="bogus")
