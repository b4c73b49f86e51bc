"""WPE dereverberation: oracle behavior, JAX parity, batch consistency.

Strategy (SURVEY.md §4 analog): the oracle is validated functionally on a
scene generated BY the model it inverts (late reverb as delayed linear
prediction of the observed signal), then the JAX path is gated against the
oracle bit-for-bit-ish (c128 vs f64, same diag load), and the batch wrapper
against the single path.
"""

from __future__ import annotations

import numpy as np
import pytest

from overiva_jax.oracle import wpe as oracle_wpe
from overiva_jax.oracle.wpe import delayed_taps as np_delayed_taps


def _ar_reverb_scene(rng, T=120, F=9, M=3, taps=4, delay=2, strength=0.45):
    """Dry STFT D + AR late reverb: X[t] = D[t] + sum_k A_k X[t-delay-k].

    Exactly the model WPE inverts, so a correct implementation removes
    most of the reverb tail. Returns (X, D)."""
    def crand(*s):
        return rng.standard_normal(s) + 1j * rng.standard_normal(s)

    # dry signal with per-frame activity modulation (speech-like PSD swings)
    env = 0.15 + rng.random((T, 1, 1)) ** 2
    D = crand(T, F, M) * env
    A = crand(taps, F, M, M) * (strength / np.sqrt(taps * M))
    X = np.zeros((T, F, M), complex)
    for t in range(T):
        acc = D[t].copy()
        for k in range(taps):
            s = t - delay - k
            if s >= 0:
                acc += np.einsum("fnm,fm->fn", A[k], X[s])
        X[t] = acc
    return X, D


def test_delayed_taps_jax_matches_oracle(rng):
    import jax.numpy as jnp

    from overiva_jax.ops.wpe import delayed_taps

    X = (rng.standard_normal((11, 5, 3)) + 1j * rng.standard_normal((11, 5, 3)))
    ref = np_delayed_taps(X, taps=4, delay=2)
    got = np.asarray(delayed_taps(jnp.asarray(X), taps=4, delay=2))
    np.testing.assert_allclose(got, ref, atol=1e-12)
    # degenerate: shift beyond T -> zero column
    ref2 = np_delayed_taps(X[:3], taps=4, delay=2)
    got2 = np.asarray(delayed_taps(jnp.asarray(X[:3]), taps=4, delay=2))
    np.testing.assert_allclose(got2, ref2, atol=1e-12)


def test_oracle_wpe_removes_ar_reverb(rng):
    X, D = _ar_reverb_scene(rng)
    Y = oracle_wpe.wpe(X, taps=6, delay=2, n_iter=3)
    before = np.mean(np.abs(X - D) ** 2)
    after = np.mean(np.abs(Y - D) ** 2)
    # the AR tail carries ~30-50% of the energy; WPE should strip >=10 dB
    assert after < before / 10.0
    # and not distort the dry part into something bigger than the scene
    assert np.mean(np.abs(Y) ** 2) < 2.0 * np.mean(np.abs(D) ** 2)


def test_oracle_wpe_iterations_refine(rng):
    X, D = _ar_reverb_scene(rng)
    e1 = np.mean(np.abs(oracle_wpe.wpe(X, 6, 2, n_iter=1) - D) ** 2)
    e3 = np.mean(np.abs(oracle_wpe.wpe(X, 6, 2, n_iter=3) - D) ** 2)
    assert e3 <= e1 * 1.05  # re-weighting should not regress


@pytest.mark.parametrize("shape", [(60, 9, 2), (40, 7, 4)])
def test_jax_wpe_matches_oracle_c128(rng, shape):
    from overiva_jax import api

    T, F, M = shape
    X = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    ref = oracle_wpe.wpe(X, taps=3, delay=1, n_iter=2)
    got = api.wpe(X, taps=3, delay=1, n_iter=2, dtype=np.complex128)
    scale = np.max(np.abs(ref))
    np.testing.assert_allclose(got, ref, atol=1e-8 * scale)


def test_jax_wpe_c64_close_and_finite(rng):
    from overiva_jax import api

    X, _ = _ar_reverb_scene(rng, T=80, F=9, M=2)
    ref = oracle_wpe.wpe(X, taps=4, delay=2, n_iter=2)
    got = api.wpe(X, taps=4, delay=2, n_iter=2)  # complex64 default
    assert np.all(np.isfinite(got))
    scale = np.max(np.abs(ref))
    np.testing.assert_allclose(got, ref, atol=3e-3 * scale)


def test_wpe_batch_matches_single(rng):
    from overiva_jax import api

    Xs = [
        _ar_reverb_scene(rng, T=40, F=7, M=2)[0] for _ in range(3)
    ]
    Xb = np.stack(Xs)
    Yb = api.wpe_batch(Xb, taps=3, delay=1, n_iter=2, dtype=np.complex128)
    for b, X in enumerate(Xs):
        Y1 = api.wpe(X, taps=3, delay=1, n_iter=2, dtype=np.complex128)
        np.testing.assert_allclose(Yb[b], Y1, atol=1e-10)


def test_wpe_then_separation_improves_reverberant_sir(rng):
    """End-to-end: on a strongly reverberant AR scene, WPE before AuxIVA
    must not break separation (output finite, dry-residual reduced)."""
    from overiva_jax import api

    X, D = _ar_reverb_scene(rng, T=100, F=17, M=2, strength=0.5)
    Y = api.wpe(X, taps=6, delay=2, n_iter=2, dtype=np.complex128,
                device=False)
    assert np.all(np.isfinite(Y))
    assert np.mean(np.abs(Y - D) ** 2) < np.mean(np.abs(X - D) ** 2)
    out = api.auxiva(Y.astype(np.complex64), n_iter=5)
    assert np.all(np.isfinite(out))


def test_separate_fused_wpe_option(rng):
    from overiva_jax import api

    mix = rng.standard_normal((4000, 3)).astype(np.float64)
    y0 = api.separate(mix, n_src=3, nfft=256, n_iter=3)
    yw = api.separate(mix, n_src=3, nfft=256, n_iter=3,
                      wpe={"taps": 4, "n_iter": 2})
    assert yw.shape == y0.shape
    assert np.all(np.isfinite(yw))
    assert not np.allclose(yw, y0)  # the front must actually run
    with pytest.raises(ValueError):
        api.separate(mix, n_src=3, nfft=256, wpe={"tap": 4})


def test_online_wpe_converges_to_batch_quality(rng):
    """Streaming WPE on a stationary AR scene: after the forgetting
    window fills, the per-block residual reverb approaches the batch
    solution's and is far below the raw input's."""
    from overiva_jax import api

    T, F, M = 360, 9, 2
    X, D = _ar_reverb_scene(rng, T=T, F=F, M=M, taps=3, delay=2)
    taps, delay, blk = 5, 2, 24
    Yb = oracle_wpe.wpe(X, taps=taps, delay=delay, n_iter=3)

    drv = api.OnlineWPE(n_freq=F, n_chan=M, taps=taps, delay=delay,
                        forget=0.99, dtype=np.complex128)
    outs = [drv.process(X[i:i + blk]) for i in range(0, T, blk)]
    Y = np.concatenate(outs, axis=0)
    assert Y.shape == X.shape and np.all(np.isfinite(Y))

    def tail_err(Z):  # residual reverb energy on the settled tail
        return np.mean(np.abs(Z[-120:] - D[-120:]) ** 2)

    raw, online, batch = tail_err(X), tail_err(Y), tail_err(Yb)
    assert online < raw / 5.0          # most of the tail removed
    assert online < batch * 3.0        # within reach of the batch solve

    # filters property exposes the current predictor
    G = drv.filters
    assert G.shape == (F, M * taps, M) and np.all(np.isfinite(G))


def test_online_wpe_validation():
    from overiva_jax import api

    with pytest.raises(ValueError):
        api.OnlineWPE(n_freq=9, n_chan=2, delay=0)
    with pytest.raises(ValueError):
        api.OnlineWPE(n_freq=9, n_chan=2, taps=0)
    with pytest.raises(ValueError):
        api.wpe(np.zeros((8, 9, 2), complex), delay=0)
    with pytest.raises(ValueError):
        api.wpe_batch(np.zeros((1, 8, 9, 2), complex), taps=0)
