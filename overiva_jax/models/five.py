"""FIVE core — fused JAX iteration (trace-side).

Mirrors the NumPy oracle (``overiva_jax/oracle/five.py``): whiten once, then
each epoch takes the minimum eigenvector of the phi-weighted whitened
covariance (batched complex eigh over all bins). Few iterations, one XLA
program.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.covariance import covariance, weighted_covariance
from ..ops.linalg import PRECISION, eigh, mat_h
from .source_models import activations_from_power, power

__all__ = ["five_whiten", "five_iterations", "five_demix"]


def five_whiten(X):
    """Returns (Xw, Q) with Q = Cx^{-1/2} (Hermitian)."""
    Cx = covariance(X)
    lam, E = eigh(Cx)
    lam = jnp.maximum(lam, 1e-15)
    scale = (lam[:, None, :] ** -0.5).astype(X.real.dtype)
    Q = jnp.matmul(E * scale, mat_h(E), precision=PRECISION)
    Xw = jnp.einsum("fmn,tfn->tfm", Q, X, precision=PRECISION)
    return Xw, Q


def five_demix(Xw, w):
    return jnp.einsum("fm,tfm->tf", jnp.conj(w), Xw, precision=PRECISION)


@partial(jax.jit, static_argnames=("n_iter", "model", "axis_name", "n_freq"))
def five_iterations(
    Xw, w, n_iter: int, model: str, axis_name=None, n_freq=None, bin_mask=None
):
    """Run n_iter minimum-eigenvector epochs in the whitened domain.

    ``axis_name``/``n_freq``/``bin_mask``: bin-sharded execution — the
    per-frame power is psum'd over the mesh axis (the single collective,
    SURVEY.md §5.8); everything else (whitened covariance, min-eigvec,
    phase fix) is per-bin local.
    """
    T, F, M = Xw.shape

    def epoch(_, w):
        y = five_demix(Xw, w)
        pw = power(y[:, :, None], bin_mask)  # (T, 1) — partial when sharded
        if axis_name is not None:
            pw = lax.psum(pw, axis_name)
        _, phi = activations_from_power(pw, n_freq or F, model)
        V = weighted_covariance(Xw, phi[:, 0])
        _, E_v = eigh(V)
        w = E_v[:, :, 0]
        # deterministic phase: rotate the largest-|.| component to real+
        mag = jnp.abs(w)
        mx = jnp.max(mag, axis=1, keepdims=True)
        sel = (mag >= mx).astype(w.real.dtype)
        # first occurrence only
        first = (jnp.cumsum(sel, axis=1) <= 1.0).astype(w.real.dtype) * sel
        ph = jnp.sum(w * first, axis=1)
        ph = ph / jnp.maximum(jnp.abs(ph), 1e-30).astype(w.real.dtype)
        return w * jnp.conj(ph)[:, None]

    return lax.fori_loop(0, n_iter, epoch, w)
