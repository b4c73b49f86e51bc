"""AuxIVA-ISS core — fused JAX iteration (trace-side).

Rank-1 source-steering updates (see the oracle twin
``overiva_jax/oracle/auxiva_iss.py``): no matrix solves anywhere, every step
is einsums + elementwise math over all bins — the fastest family member on
accelerator (no Gauss-Jordan chains, only elementwise work and contractions).

Layout note (docs/DESIGN.md §2b): unlike the IP update chain, ISS does NOT
benefit from the bin-minor layout — its operands are (T, F) slices whose
lane axis is already the bin axis, and its contractions are over frames,
which XLA lowers to batched dots. A fully bin-minor epoch measured
about five times slower than this einsum form at the headline shape
(M=8, F=2049, T=128) on the first accelerator, so F-major stays; not yet
re-measured on the GPU.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.linalg import PRECISION
from .overiva import demix
from .source_models import activations_from_power, power

__all__ = ["auxiva_iss_iterations"]

_EPS = 1e-15


def _iss_epoch(
    X, state, model, axis_name=None, n_freq=None, bin_mask=None, n_src=None
):
    """One ISS epoch. ``n_src < M`` gives OverIVA-ISS (oracle twin
    ``oracle/overiva_iss.py``): the first n_src outputs carry the source
    model, the rest a stationary unit-Gaussian background (phi = 1)."""
    W, Y = state
    T, F, M = X.shape
    N = M if n_src is None else n_src
    pw = power(Y[:, :, :N], bin_mask)
    if axis_name is not None:
        pw = lax.psum(pw, axis_name)
    _, phi = activations_from_power(pw, n_freq or F, model)
    phif = phi.astype(Y.real.dtype)
    if N < M:
        phif = jnp.concatenate(
            [phif, jnp.ones((T, M - N), phif.dtype)], axis=1
        )

    for n in range(M):  # static unroll, order-dependent
        yn = Y[:, :, n]
        num = jnp.einsum("tm,tfm,tf->fm", phif, Y, jnp.conj(yn), precision=PRECISION)
        den = jnp.real(
            jnp.einsum("tm,tf,tf->fm", phif, yn, jnp.conj(yn), precision=PRECISION)
        )
        v = num / jnp.maximum(den, _EPS).astype(num.real.dtype)
        dnn = den[:, n] / T
        vnn = 1.0 - jax.lax.rsqrt(jnp.maximum(dnn, _EPS))
        col = jnp.arange(M)[None, :] == n
        v = jnp.where(col, vnn.astype(v.real.dtype)[:, None], v)
        Y = Y - v[None, :, :] * yn[:, :, None]
        W = W - v[:, :, None] * W[:, n, :][:, None, :]
    return W, Y


@partial(
    jax.jit,
    static_argnames=("n_iter", "model", "axis_name", "n_freq", "n_src"),
)
def auxiva_iss_iterations(
    X,
    W,
    n_iter: int,
    model: str,
    axis_name=None,
    n_freq=None,
    bin_mask=None,
    n_src=None,
):
    """Run n_iter fused ISS epochs (OverIVA-ISS when n_src < M).

    Returns (W, Y) with the full M-channel state; OverIVA-ISS callers take
    Y[:, :, :n_src]."""
    Y = demix(X, W)
    W, Y = lax.fori_loop(
        0,
        n_iter,
        lambda _, s: _iss_epoch(
            X, s, model, axis_name, n_freq, bin_mask, n_src
        ),
        (W, Y),
    )
    return W, Y
