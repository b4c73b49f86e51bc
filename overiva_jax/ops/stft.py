"""JAX STFT frontend (the device path).

Same conventions as the NumPy oracle (``overiva_jax/oracle/stft.py``,
SURVEY.md §2.3.7): hann analysis window, canonical-dual synthesis window,
hop = nfft//2 by default, frames-first complex output ``(T, nfft//2+1, M)``.

Framing is a gather + elementwise window multiply that XLA fuses into the
rfft's input; the rfft lowers to the XLA FFT (cuFFT on the GPU). These functions are
trace-side (complex in/out) — public numpy-in/out wrappers live in
``overiva_jax.api`` and keep complex away from the host boundary.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from ..oracle.stft import hann, synthesis_window

__all__ = ["analysis", "synthesis", "hann", "synthesis_window", "n_frames_of"]


def n_frames_of(n_samples: int, nfft: int, hop: int) -> int:
    return (n_samples - nfft) // hop + 1


def analysis(x, nfft: int, hop: int, win: np.ndarray | None = None):
    """x: (n_samples, M) real -> X: (T, nfft//2+1, M) complex. Trace-side."""
    x = jnp.asarray(x)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    if win is None:
        win = hann(nfft)
    win = jnp.asarray(win, dtype=x.dtype)
    if x.shape[0] < nfft:  # host-side (shapes are static under trace)
        raise ValueError("signal shorter than one frame")
    T = n_frames_of(x.shape[0], nfft, hop)
    idx = jnp.arange(nfft)[None, :] + hop * jnp.arange(T)[:, None]
    frames = x[idx, :] * win[None, :, None]  # (T, nfft, M)
    X = jnp.fft.rfft(frames, n=nfft, axis=1)
    return X[:, :, 0] if squeeze else X


def synthesis(X, nfft: int, hop: int, win_s: np.ndarray | None = None):
    """X: (T, nfft//2+1, M) complex -> (n_samples, M) real. Trace-side.

    Weighted overlap-add implemented as a strided scatter-add.
    """
    X = jnp.asarray(X)
    squeeze = X.ndim == 2
    if squeeze:
        X = X[:, :, None]
    if win_s is None:
        win_s = synthesis_window(hann(nfft), hop)
    frames = jnp.fft.irfft(X, n=nfft, axis=1)
    win_s = jnp.asarray(win_s, dtype=frames.dtype)
    frames = frames * win_s[None, :, None]
    T, _, M = frames.shape
    n = (T - 1) * hop + nfft
    idx = (jnp.arange(nfft)[None, :] + hop * jnp.arange(T)[:, None]).reshape(-1)
    out = jnp.zeros((n, M), dtype=frames.dtype)
    out = out.at[idx, :].add(frames.reshape(T * nfft, M))
    return out[:, 0] if squeeze else out
