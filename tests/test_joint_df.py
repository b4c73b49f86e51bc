"""acc="f32x2" (double-float) T-ISS / T-IP vs the float64 oracles.

Why: tip was the thinnest-margin family on the 10-seed
hardware certification (0.061/0.027 dB vs the 0.1 gate). The df tier
extended to the joint family (models/joint_df.py) must reproduce the f64
oracle run on the c64-quantized input to ~1e-6 relative element-wise
deltas, the same equivalence target as tests/test_overiva_df.py.
"""

import numpy as np
import pytest

from overiva_jax import api, oracle


@pytest.fixture
def mixture(rng):
    # convolutive-ish: random FIR mixing so the tap block has real work
    T, F, M, N = 60, 17, 3, 2
    S = rng.standard_normal((T, F, N)) + 1j * rng.standard_normal((T, F, N))
    A = rng.standard_normal((F, M, N)) + 1j * rng.standard_normal((F, M, N))
    X = np.einsum("fmn,tfn->tfm", A, S)
    # delayed leakage to give dereverberation taps something to remove
    X[2:] += 0.3 * np.einsum("fmn,tfn->tfm", A, S)[:-2]
    X += 0.01 * (rng.standard_normal(X.shape) + 1j * rng.standard_normal(X.shape))
    return X.astype(np.complex64)


@pytest.mark.parametrize("model", ["laplace", "gauss"])
def test_tiss_df_matches_f64_oracle(mixture, model):
    Y = api.tiss(mixture, n_src=2, taps=2, delay=1, n_iter=6,
                 model=model, acc="f32x2")
    Yo = oracle.tiss(mixture.astype(np.complex128), n_src=2, taps=2,
                     delay=1, n_iter=6, model=model)
    assert np.abs(Y - Yo).max() / np.abs(Yo).max() < 1e-6


def test_tiss_df_determined_no_taps_filters(mixture):
    # taps=0, n_src=M degenerates to AuxIVA; also exercises filters out
    Y, P = api.tiss(mixture, taps=0, n_iter=5, acc="f32x2",
                    return_filters=True)
    Yo, Po = oracle.tiss(mixture.astype(np.complex128), taps=0, n_iter=5,
                         return_filters=True)
    assert np.abs(Y - Yo).max() / np.abs(Yo).max() < 1e-6
    assert np.abs(P - Po).max() / np.abs(Po).max() < 1e-6


@pytest.mark.parametrize("model", ["laplace", "gauss"])
def test_tip_df_matches_f64_oracle(mixture, model):
    # warm_iter T-ISS epochs run inside the df program too
    Y = api.tip(mixture, n_src=2, taps=2, delay=1, n_iter=4, warm_iter=3,
                model=model, acc="f32x2")
    Yo = oracle.tip(mixture.astype(np.complex128), n_src=2, taps=2,
                    delay=1, n_iter=4, warm_iter=3, model=model)
    assert np.abs(Y - Yo).max() / np.abs(Yo).max() < 1e-6


def test_tip_df_w0_and_filters(mixture):
    _, P0 = api.tiss(mixture, n_src=2, taps=2, delay=1, n_iter=2,
                     return_filters=True)
    Y, P = api.tip(mixture, n_src=2, taps=2, delay=1, n_iter=3, W0=P0,
                   acc="f32x2", return_filters=True)
    Yo, Po = oracle.tip(mixture.astype(np.complex128), n_src=2, taps=2,
                        delay=1, n_iter=3, W0=P0.astype(np.complex128),
                        return_filters=True)
    assert np.abs(Y - Yo).max() / np.abs(Yo).max() < 1e-6
    assert np.abs(P - Po).max() / np.abs(Po).max() < 1e-6


def test_joint_df_callback_cadence(mixture):
    snaps = []
    api.tiss(mixture, n_src=2, taps=2, delay=1, n_iter=5, acc="f32x2",
             callback=lambda y: snaps.append(np.abs(y).mean()),
             callback_every=2)
    assert len(snaps) == 3  # epochs 0, 2, 4 — reference cadence
    assert all(np.isfinite(s) for s in snaps)
    snaps_tip = []
    api.tip(mixture, n_src=2, taps=2, delay=1, n_iter=4, warm_iter=2,
            acc="f32x2",
            callback=lambda y: snaps_tip.append(np.abs(y).mean()),
            callback_every=2)
    assert len(snaps_tip) == 2
    oracle_snaps = []
    oracle.tiss(mixture.astype(np.complex128), n_src=2, taps=2, delay=1,
                n_iter=5,
                callback=lambda y: oracle_snaps.append(np.abs(y).mean()),
                callback_every=2)
    assert len(oracle_snaps) == len(snaps)
    np.testing.assert_allclose(snaps, oracle_snaps, rtol=1e-6)


def test_joint_df_kwarg_guards(mixture):
    with pytest.raises(ValueError, match="acc"):
        api.tiss(mixture, acc="bogus")
    with pytest.raises(ValueError, match="dtype"):
        api.tiss(mixture, acc="f32x2", dtype=np.complex128)
    with pytest.raises(ValueError, match="wcov"):
        api.tip(mixture, acc="f32x2", wcov="bf16")
