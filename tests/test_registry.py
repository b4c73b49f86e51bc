"""Algorithm registry + audio utils."""

import numpy as np
import pytest

from overiva_jax.registry import ALGORITHMS, applicable, get_algorithm
from overiva_jax.utils.audio import AudioPlayer, save_wavs

from helpers import make_mixture, stft_mixture


def test_registry_names_cover_reference_cli():
    for name in [
        "auxiva", "auxiva-gauss", "overiva", "overiva-gauss",
        "auxiva_pca", "ilrma", "ogive", "ogive-mix", "ogive-switching",
    ]:
        assert name in ALGORITHMS


def test_unknown_algorithm_raises():
    with pytest.raises(ValueError):
        get_algorithm("fastica")


def test_applicability_rules():
    assert applicable("auxiva", 2, 2) and not applicable("auxiva", 2, 5)
    assert applicable("overiva", 2, 5) and not applicable("overiva", 6, 5)
    assert applicable("ogive", 1, 5) and not applicable("ogive", 2, 5)
    assert applicable("ilrma", 3, 3) and not applicable("ilrma", 2, 3)


def test_registry_runs_algorithm():
    rng = np.random.default_rng(51)
    mix, premix, _ = make_mixture(rng, n_src=2, n_mics=3, n_samples=12000, snr_db=25)
    X = stft_mixture(mix, nfft=256)
    Y = get_algorithm("overiva")(X, n_src=2, n_iter=5)
    assert Y.shape == (X.shape[0], X.shape[1], 2)


def test_save_wavs(tmp_path, rng):
    paths = save_wavs(tmp_path, 16000, {"a": rng.standard_normal(1000),
                                        "b": rng.standard_normal((1000, 2))})
    assert all(p.exists() for p in paths)
    player = AudioPlayer(paths)
    assert isinstance(player.player, (str, type(None)))


def test_df_registry_names(rng):
    # certification-tier names dispatch the acc="f32x2" path and honor
    # the batch contract (per-element loop — documented non-fused)
    from overiva_jax.registry import get_algorithm

    X = (rng.standard_normal((40, 9, 3))
         + 1j * rng.standard_normal((40, 9, 3))).astype(np.complex64)
    spec = get_algorithm("overiva-gauss-df")
    Y = spec(X, n_src=2, n_iter=3)
    assert Y.shape == (40, 9, 2) and np.isfinite(Y).all()
    Yb = spec.run_batch(np.stack([X, X]), n_src=2, n_iter=3)
    assert Yb.shape == (2, 40, 9, 2)
    np.testing.assert_array_equal(Yb[0], Yb[1])
    np.testing.assert_array_equal(Yb[0], Y)


def test_joint_df_registry_names(rng):
    # joint-family certification names (models/joint_df.py): acc="f32x2"
    # without forcing a model; batch = documented per-element loop
    X = (rng.standard_normal((40, 9, 3))
         + 1j * rng.standard_normal((40, 9, 3))).astype(np.complex64)
    for name, kw in (("tiss-df", dict(n_iter=2)),
                     ("tip-df", dict(n_iter=1, warm_iter=1))):
        spec = get_algorithm(name)
        Y = spec(X, n_src=2, taps=1, delay=1, **kw)
        assert Y.shape == (40, 9, 2) and np.isfinite(Y).all()
        Yb = spec.run_batch(np.stack([X, X]), n_src=2, taps=1, delay=1, **kw)
        assert Yb.shape == (2, 40, 9, 2)
        np.testing.assert_array_equal(Yb[0], Yb[1])
        np.testing.assert_array_equal(Yb[0], Y)
