"""Shared test fixtures: deterministic synthetic convolutive mixtures.

Builds seeded random-FIR convolutive mixtures of sparse (Laplacian-like)
sources — the integration-test strategy from SURVEY.md §4: separate, then
check bss_eval SDR improvement and oracle parity under identical init.
"""

from __future__ import annotations

import numpy as np

from overiva_jax.oracle import analysis, stft_pad


def make_sources(rng, n_src: int, n_samples: int) -> np.ndarray:
    """Sparse, spectrally-distinct super-Gaussian sources, (n_src, n_samples)."""
    # Laplacian amplitude gated by per-source random on/off block envelopes:
    # distinct time-varying power patterns are what both the laplace and the
    # gauss source priors latch onto (speech-like activity).
    src = rng.laplace(size=(n_src, n_samples))
    block = max(n_samples // 32, 1)
    n_blocks = -(-n_samples // block)
    for k in range(n_src):
        gates = np.where(rng.random(n_blocks) < 0.45, 1.0, 0.05)
        env = np.repeat(gates, block)[:n_samples]
        # smooth gate edges to avoid spectral splatter
        kernel = np.hanning(129)
        kernel /= kernel.sum()
        env = np.convolve(env, kernel, mode="same")
        src[k] *= env
        # distinct coloration per source
        b = np.array([1.0, 0.5 * (-1) ** k, 0.2 * (k + 1) / n_src])
        src[k] = np.convolve(src[k], b, mode="same")
    src /= np.std(src, axis=1, keepdims=True)
    return src


def make_mixture(
    rng,
    n_src: int = 2,
    n_mics: int = 2,
    n_samples: int = 16000,
    n_taps: int = 8,
    snr_db: float = 30.0,
):
    """Random-FIR convolutive mixture.

    Returns (mix, premix, src):
      mix:    (n_samples, n_mics) microphone signals
      premix: (n_src, n_samples, n_mics) per-source images at the mics
      src:    (n_src, n_samples) dry sources
    """
    src = make_sources(rng, n_src, n_samples)
    H = rng.standard_normal((n_mics, n_src, n_taps))
    H[:, :, 0] += 2.0 * np.sign(H[:, :, 0])  # direct path dominant -> mixable
    premix = np.zeros((n_src, n_samples, n_mics))
    for m in range(n_mics):
        for k in range(n_src):
            premix[k, :, m] = np.convolve(src[k], H[m, k], mode="full")[:n_samples]
    mix = premix.sum(axis=0)
    if np.isfinite(snr_db):
        noise = rng.standard_normal(mix.shape)
        noise *= np.linalg.norm(mix) / np.linalg.norm(noise) * 10 ** (-snr_db / 20)
        mix = mix + noise
    return mix, premix, src


def stft_mixture(mix: np.ndarray, nfft: int = 256, hop: int | None = None):
    """Pad + analyze a (n_samples, n_mics) mixture; returns (X, pad_info)."""
    hop = hop or nfft // 2
    xp = stft_pad(mix, nfft, hop)
    X = analysis(xp, nfft, hop)
    return X
