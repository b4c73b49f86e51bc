"""Registry-wide smoke: EVERY algorithm name runs through the single
dispatch point on a tiny mixture and returns the documented shape.

Catches wiring regressions (new families forgetting registry defaults,
signature drift between api functions and AlgorithmSpec) that the
per-family test files can miss. Quality is not asserted here — the
per-family files own that; this is shape/finiteness only, at 2
iterations on a 3-mic mixture.
"""

import numpy as np
import pytest

from overiva_jax.registry import ALGORITHMS, applicable

from helpers import make_mixture, stft_mixture


@pytest.fixture(scope="module")
def mixture33():
    rng = np.random.default_rng(23)
    mix, _, _ = make_mixture(
        rng, n_src=3, n_mics=3, n_samples=16000, n_taps=6, snr_db=25
    )
    return stft_mixture(mix, 256)


@pytest.mark.parametrize("name", sorted(ALGORITHMS))
def test_every_algorithm_dispatches(name, mixture33):
    X = mixture33
    T, F, M = X.shape
    spec = ALGORITHMS[name]
    # pick the smallest applicable n_src for this 3-chan mixture
    n_src = next(
        (n for n in (1, 2, 3) if applicable(name, n, M)), None
    )
    assert n_src is not None, f"{name} applicable to no n_src at M={M}"
    kw = {}
    if "n_iter" in spec.defaults:
        kw["n_iter"] = min(spec.defaults["n_iter"], 40)
    Y = spec(X, n_src=n_src, **kw)
    assert Y.shape == (T, F, n_src), (name, Y.shape)
    assert np.isfinite(Y).all(), name


def test_registry_names_are_complete():
    """The families documented in docs/API.md are all registered."""
    expected = {
        "auxiva", "auxiva-gauss", "auxiva-iss", "auxiva-iss-gauss",
        "overiva", "overiva-gauss", "overiva-iss", "overiva-iss-gauss",
        "overiva-ip2", "overiva-ip2-gauss", "auxiva_pca", "auxiva_pca-iss",
        "auxiva_pca-ip2",
        "sparseauxiva", "ilrma", "ilrma-t", "fastmnmf", "fastmnmf2", "five",
        "ogive", "ogive-mix", "ogive-switching", "tiss", "tiss-gauss",
        "tip", "tip-gauss", "overiva-gauss-df", "auxiva-gauss-df",
        "tiss-df", "tip-df",
    }
    assert expected == set(ALGORITHMS), (
        expected ^ set(ALGORITHMS)
    )
