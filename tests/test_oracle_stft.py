"""Oracle STFT: perfect reconstruction and convention checks (SURVEY.md §4)."""

import numpy as np
import pytest

from overiva_jax.oracle import analysis, hann, stft_pad, synthesis, synthesis_window


@pytest.mark.parametrize("nfft,hop", [(256, 128), (512, 256), (512, 128), (4096, 2048)])
def test_perfect_reconstruction(rng, nfft, hop):
    x = rng.standard_normal(8 * nfft)
    xp = stft_pad(x, nfft, hop)
    X = analysis(xp, nfft, hop)
    y = synthesis(X, nfft, hop)
    start = nfft - hop
    np.testing.assert_allclose(y[start : start + len(x)], x, atol=1e-10)


def test_multichannel_shapes(rng):
    nfft, hop, M = 256, 128, 3
    x = rng.standard_normal((4 * nfft, M))
    X = analysis(x, nfft, hop)
    T = (x.shape[0] - nfft) // hop + 1
    assert X.shape == (T, nfft // 2 + 1, M)
    y = synthesis(X, nfft, hop)
    assert y.shape == ((T - 1) * hop + nfft, M)


def test_dual_window_identity():
    nfft, hop = 512, 256
    w = hann(nfft)
    d = synthesis_window(w, hop)
    # sum_m w[n - m*hop] d[n - m*hop] == 1 on a long support
    n = 8 * nfft
    acc = np.zeros(n)
    for m in range(0, (n - nfft) // hop + 1):
        acc[m * hop : m * hop + nfft] += w * d
    interior = acc[nfft : n - nfft]
    np.testing.assert_allclose(interior, 1.0, atol=1e-12)


def test_analysis_linearity(rng):
    nfft, hop = 256, 128
    a = rng.standard_normal(1024)
    b = rng.standard_normal(1024)
    Xa = analysis(a, nfft, hop)
    Xb = analysis(b, nfft, hop)
    Xab = analysis(a + 2 * b, nfft, hop)
    np.testing.assert_allclose(Xab, Xa + 2 * Xb, atol=1e-10)
