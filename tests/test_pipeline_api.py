"""Fused time->time pipeline + filter checkpointing."""

import numpy as np

from overiva_jax import api
from overiva_jax.utils.checkpoint import load_filters, save_filters

from helpers import make_mixture


def test_separate_time_matches_staged():
    rng = np.random.default_rng(71)
    mix, premix, _ = make_mixture(rng, n_src=2, n_mics=3, n_samples=12000, snr_db=25)
    nfft, hop = 512, 256
    y = api.separate(mix, n_src=2, nfft=nfft, n_iter=10, dtype=np.complex128)
    assert y.shape == (mix.shape[0], 2)
    # staged path on identical input
    from overiva_jax.oracle import stft_pad

    X = api.stft_analysis(stft_pad(mix, nfft, hop), nfft, dtype=np.complex128)
    Y = api.overiva(X, n_src=2, n_iter=10, dtype=np.complex128)
    y2 = api.stft_synthesis(Y, nfft, dtype=np.complex128)[nfft - hop :][: mix.shape[0]]
    np.testing.assert_allclose(y, y2, rtol=1e-8, atol=1e-10)


def test_filter_checkpoint_roundtrip(tmp_path, rng):
    W = rng.standard_normal((5, 3, 3)) + 1j * rng.standard_normal((5, 3, 3))
    p = save_filters(tmp_path / "w.npz", W, algo="overiva", n_iter=20)
    W2, meta = load_filters(tmp_path / "w.npz")
    np.testing.assert_allclose(W2, W)
    assert meta["algo"] == "overiva" and meta["n_iter"] == 20


def test_checkpoint_warm_start(tmp_path):
    rng = np.random.default_rng(72)
    mix, _, _ = make_mixture(rng, n_src=2, n_mics=4, n_samples=12000, snr_db=25)
    from helpers import stft_mixture

    X = stft_mixture(mix, nfft=256)
    Y1, W1 = api.overiva(X, n_src=2, n_iter=6, return_filters=True, dtype=np.complex128)
    save_filters(tmp_path / "ckpt.npz", W1)
    W1b, _ = load_filters(tmp_path / "ckpt.npz")
    Y2 = api.overiva(X, n_src=2, n_iter=0, W0=W1b, proj_back=True, dtype=np.complex128)
    # resuming with zero extra iterations reproduces the checkpointed output
    np.testing.assert_allclose(Y2, Y1, rtol=1e-9, atol=1e-11)


def test_separate_iss_path():
    """The fused serving path with algo='iss' (OverIVA-ISS when n_src < M)
    matches the composed overiva_iss pipeline."""
    import numpy as np

    from overiva_jax import api
    from overiva_jax.oracle import stft_pad

    from helpers import make_mixture

    rng = np.random.default_rng(71)
    mix, _, _ = make_mixture(rng, n_src=2, n_mics=4, n_samples=16000, snr_db=25)
    y = api.separate(mix, n_src=2, nfft=256, n_iter=10, algo="iss",
                     dtype=np.complex128)
    assert y.shape == (mix.shape[0], 2)
    X = api.stft_analysis(stft_pad(mix, 256, 128), 256, dtype=np.complex128)
    Yref = api.overiva_iss(X, n_src=2, n_iter=10, dtype=np.complex128)
    yref = api.stft_synthesis(Yref, 256, dtype=np.complex128)[128:][: mix.shape[0]]
    np.testing.assert_allclose(y, yref, rtol=1e-7, atol=1e-9)

    import pytest
    with pytest.raises(ValueError):
        api.separate(mix, n_src=2, algo="nope")


def test_separate_fastmnmf_algos():
    """Fused time pipeline with the full-rank spatial family: separates a
    3-mic mixture to high SIR and returns n_src channels (Wiener images
    at mic 0 — no projection back in this branch)."""
    import numpy as np

    from overiva_jax import api
    from overiva_jax.metrics import BssEvalReferences

    from helpers import make_mixture

    rng = np.random.default_rng(11)
    mix, premix, _ = make_mixture(
        rng, n_src=2, n_mics=3, n_samples=24000, n_taps=8, snr_db=25
    )
    ev = BssEvalReferences(premix[:, :, 0])
    for algo in ("fastmnmf2", "fastmnmf"):
        y = api.separate(mix, n_src=2, nfft=512, n_iter=30, algo=algo)
        assert y.shape == (mix.shape[0], 2) and np.isfinite(y).all()
        _, sir, _, _ = ev.evaluate(y.T)
        assert sir.mean() > 15, (algo, sir)


def test_streaming_state_checkpoint_roundtrip(tmp_path, rng):
    """OnlineWPE/OnlineAuxIVAISS save/restore: a restored instance
    continues the stream bit-identically to the uninterrupted one."""
    from overiva_jax import api

    F, M, B = 9, 2, 12
    blocks = [
        (rng.standard_normal((B, F, M)) + 1j * rng.standard_normal((B, F, M)))
        .astype(np.complex64) for _ in range(6)
    ]

    for make in (
        lambda: api.OnlineWPE(n_freq=F, n_chan=M, taps=3, delay=2),
        lambda: api.OnlineAuxIVAISS(n_freq=F, n_chan=M, forget=0.95),
    ):
        a = make()
        for blk in blocks[:3]:
            a.process(blk)
        p = a.save(tmp_path / "stream.npz", note="midstream")
        b = make()
        meta = b.restore(p)
        assert meta["note"] == "midstream"
        for blk in blocks[3:]:
            ya = a.process(blk)
            yb = b.process(blk)
            np.testing.assert_allclose(yb, ya, atol=1e-7)

    # shape mismatch is a clear error, not silent corruption
    c = api.OnlineWPE(n_freq=F + 2, n_chan=M, taps=3, delay=2)
    import pytest as _pytest
    with _pytest.raises(ValueError):
        c.restore(tmp_path / "stream.npz")


def test_stft_synthesis_batch_matches_per_lane(rng):
    """One fused batch iSTFT (the sweep harness's output path) must equal
    per-lane stft_synthesis exactly."""
    nfft = 256
    Xb = (
        rng.standard_normal((4, 30, nfft // 2 + 1, 3))
        + 1j * rng.standard_normal((4, 30, nfft // 2 + 1, 3))
    ).astype(np.complex128)
    yb = api.stft_synthesis_batch(Xb, nfft, dtype=np.complex128)
    for b in range(Xb.shape[0]):
        y = api.stft_synthesis(Xb[b], nfft, dtype=np.complex128)
        np.testing.assert_allclose(yb[b], y, rtol=1e-12, atol=1e-12)


def test_stft_synthesis_win_s_is_used(rng):
    """win_s must actually be applied (it was silently dropped once): the
    canonical dual window passed explicitly reproduces the default path,
    and a different window changes the output."""
    from overiva_jax.ops.stft import hann, synthesis_window

    nfft, hop = 256, 128
    X = (
        rng.standard_normal((20, nfft // 2 + 1, 2))
        + 1j * rng.standard_normal((20, nfft // 2 + 1, 2))
    ).astype(np.complex128)
    dual = synthesis_window(hann(nfft), hop)
    y_default = api.stft_synthesis(X, nfft, dtype=np.complex128)
    y_dual = api.stft_synthesis(X, nfft, win_s=dual, dtype=np.complex128)
    np.testing.assert_allclose(y_dual, y_default, rtol=1e-12, atol=1e-12)
    y_other = api.stft_synthesis(
        X, nfft, win_s=np.ones(nfft), dtype=np.complex128
    )
    assert not np.allclose(y_other, y_default)
    yb_other = api.stft_synthesis_batch(
        X[None], nfft, win_s=np.ones(nfft), dtype=np.complex128
    )
    np.testing.assert_allclose(yb_other[0], y_other, rtol=1e-12, atol=1e-12)
