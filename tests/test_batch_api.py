"""Batched (vmap) single-chip separation matches the per-mixture path,
for every family (overiva / iss / overiva-iss / ogive / five)."""

import numpy as np
import pytest

from overiva_jax import api

from helpers import make_mixture, stft_mixture


@pytest.fixture(scope="module")
def batch43():
    Xs = []
    for seed in (61, 62, 63):
        rng = np.random.default_rng(seed)
        mix, _, _ = make_mixture(rng, n_src=2, n_mics=4, n_samples=12000, snr_db=25)
        Xs.append(stft_mixture(mix, nfft=256))
    return np.stack(Xs)


def test_overiva_batch_matches_loop(batch43):
    batch = batch43
    Yb = api.overiva_batch(batch, n_src=2, n_iter=8, dtype=np.complex128)
    for b in range(3):
        Yref = api.overiva(batch[b], n_src=2, n_iter=8, dtype=np.complex128)
        np.testing.assert_allclose(Yb[b], Yref, rtol=1e-7, atol=1e-9)


def test_overiva_batch_validates():
    X = np.zeros((2, 10, 9, 3), np.complex64)
    with pytest.raises(ValueError):
        api.overiva_batch(X, n_src=5)


def test_auxiva_iss_batch_matches_loop(batch43):
    batch = batch43
    Yb = api.auxiva_iss_batch(batch, n_iter=8, dtype=np.complex128)
    for b in range(3):
        Yref = api.auxiva_iss(batch[b], n_iter=8, dtype=np.complex128)
        np.testing.assert_allclose(Yb[b], Yref, rtol=1e-7, atol=1e-9)


def test_overiva_iss_batch_matches_loop(batch43):
    batch = batch43
    Yb = api.overiva_iss_batch(batch, n_src=2, n_iter=8, dtype=np.complex128)
    assert Yb.shape == batch.shape[:3] + (2,)
    for b in range(3):
        Yref = api.overiva_iss(batch[b], n_src=2, n_iter=8, dtype=np.complex128)
        np.testing.assert_allclose(Yb[b], Yref, rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("update", ["demix", "switching"])
def test_ogive_batch_matches_loop(batch43, update):
    batch = batch43
    Yb = api.ogive_batch(
        batch, n_iter=40, step_size=0.05, tol=0, update=update,
        dtype=np.complex128,
    )
    for b in range(3):
        Yref = api.ogive(
            batch[b], n_iter=40, step_size=0.05, tol=0, update=update,
            dtype=np.complex128,
        )
        np.testing.assert_allclose(Yb[b], Yref, rtol=1e-7, atol=1e-9)


def test_ogive_batch_early_exit_per_element(batch43):
    """Elements that converge first must freeze exactly where the unbatched
    early-exit run stops (vmapped while_loop keeps iterating on the rest)."""
    batch = batch43
    Yb, epochs = api.ogive_batch(
        batch, n_iter=400, step_size=0.05, tol=2e-3, update="demix",
        return_epochs=True, dtype=np.complex128,
    )
    assert epochs.shape == (3,)
    for b in range(3):
        Yref = api.ogive(
            batch[b], n_iter=400, step_size=0.05, tol=2e-3, update="demix",
            dtype=np.complex128,
        )
        np.testing.assert_allclose(Yb[b], Yref, rtol=1e-7, atol=1e-9)


def test_five_batch_matches_loop(batch43):
    batch = batch43
    Yb = api.five_batch(batch, n_iter=5, dtype=np.complex128)
    for b in range(3):
        Yref = api.five(batch[b], n_iter=5, dtype=np.complex128)
        np.testing.assert_allclose(Yb[b], Yref, rtol=1e-6, atol=1e-8)


def test_fastmnmf2_batch_matches_loop(batch43):
    batch = batch43
    Yb = api.fastmnmf2_batch(
        batch, n_src=2, n_iter=6, seed=9, dtype=np.complex128
    )
    for b in range(3):
        Yref = api.fastmnmf2(
            batch[b], n_src=2, n_iter=6, seed=9 + b, dtype=np.complex128
        )
        np.testing.assert_allclose(Yb[b], Yref, rtol=1e-6, atol=1e-8)


def test_ilrma_batch_matches_loop(batch43):
    batch = batch43
    Yb = api.ilrma_batch(batch, n_iter=6, seed=9, dtype=np.complex128)
    for b in range(3):
        Yref = api.ilrma(batch[b], n_iter=6, seed=9 + b, dtype=np.complex128)
        np.testing.assert_allclose(Yb[b], Yref, rtol=1e-7, atol=1e-9)


def test_ilrma_batch_explicit_seeds(batch43):
    """seeds=[s]*B makes every element reproduce ilrma(X[b], seed=s) — the
    sweep harness relies on this to keep batched JSONs identical."""
    batch = batch43
    Yb = api.ilrma_batch(batch, n_iter=4, seeds=[5, 5, 5], dtype=np.complex128)
    for b in range(3):
        Yref = api.ilrma(batch[b], n_iter=4, seed=5, dtype=np.complex128)
        np.testing.assert_allclose(Yb[b], Yref, rtol=1e-7, atol=1e-9)
    with pytest.raises(ValueError):
        api.ilrma_batch(batch, seeds=[1, 2])


def test_fastmnmf2_batch_explicit_seeds(batch43):
    batch = batch43
    Yb = api.fastmnmf2_batch(
        batch, n_src=2, n_iter=4, seeds=[3, 3, 3], dtype=np.complex128
    )
    for b in range(3):
        Yref = api.fastmnmf2(batch[b], n_src=2, n_iter=4, seed=3, dtype=np.complex128)
        np.testing.assert_allclose(Yb[b], Yref, rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("inner", ["ip", "iss", "ip2"])
def test_auxiva_pca_batch_matches_loop(batch43, inner):
    batch = batch43
    Yb = api.auxiva_pca_batch(
        batch, n_src=2, n_iter=8, inner=inner, dtype=np.complex128
    )
    for b in range(3):
        Yref = api.auxiva_pca(
            batch[b], n_src=2, n_iter=8, inner=inner, dtype=np.complex128
        )
        np.testing.assert_allclose(Yb[b], Yref, rtol=1e-7, atol=1e-9)


def test_registry_batch_dispatch(batch43):
    """Every registry entry exposes a batch path and it matches the
    per-instance spec call (sweep-harness contract)."""
    from overiva_jax.registry import ALGORITHMS

    batch = batch43
    assert all(s.batch is not None for s in ALGORITHMS.values())
    for name in ("auxiva", "overiva-gauss", "auxiva_pca-iss"):
        spec = ALGORITHMS[name]
        n_src = 4 if spec.determined else 2
        Yb = spec.run_batch(batch, n_src=n_src, n_iter=4, dtype=np.complex128)
        for b in range(3):
            Yref = spec(batch[b], n_src=n_src, n_iter=4, dtype=np.complex128)
            np.testing.assert_allclose(Yb[b], Yref, rtol=1e-7, atol=1e-9)
