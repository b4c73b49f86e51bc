"""T-ISS core — joint dereverberation + separation, fused JAX iteration.

JAX twin of ``overiva_jax/oracle/tiss.py`` (derivation and provenance
there). Structure per epoch on the augmented input
``Xt = [X | delayed_taps(X)]`` of shape (T, F, M + M*taps):

- M source-steering steps: statically unrolled, identical math to
  ``models/auxiva_iss._iss_epoch`` but applied to the (F, M, M+MK)
  augmented demixing rows — each step is frame-axis einsums over all bins
  (contractions, F-major layout for the same reason as ISS).
- MK tap-steering steps: a ``lax.scan`` over delayed-observation columns.
  All MK weighted denominators  den[f, m, j] = sum_t phi[t, m] |z_j|^2
  depend only on phi, so they are hoisted out of the scan as ONE
  (T,M)x(T,F,MK) einsum; the scan body is then a single numerator einsum
  + rank-1 Y update. The P tap-block decrements don't feed back into the
  scan (only Y does), so they are applied once from the stacked scan
  outputs instead of per-step scatters.

Sharding: bins are independent given phi (the taps are per-bin delays in
the STFT domain), so the only collective remains the per-frame power psum
— T-ISS slots into the §3 single-psum family unchanged.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.linalg import PRECISION
from ..ops.wpe import delayed_taps
from .overiva import demix
from .source_models import activations_from_power, power

__all__ = ["tiss_iterations", "augment_taps", "augmented_eye"]

_EPS = 1e-15


def augment_taps(X, taps: int, delay: int):
    """(T, F, M) -> (T, F, M + M*taps) augmented input (device-side)."""
    if taps == 0:
        return X
    return jnp.concatenate([X, delayed_taps(X, taps, delay)], axis=2)


def augmented_eye(Xt, n_chan: int):
    """Identity-initialized augmented demixing: (F, n_chan, MJ) with the
    instantaneous block = I and a zero tap block (the shared init of
    every joint-dereverb member; traceable, usable under shard_map)."""
    P = jnp.zeros((Xt.shape[1], n_chan, Xt.shape[2]), Xt.dtype)
    return P.at[:, :, :n_chan].set(jnp.eye(n_chan, dtype=Xt.dtype))


def _tiss_epoch(
    Xt, state, model, n_chan, axis_name=None, n_freq=None, bin_mask=None,
    n_src=None,
):
    """One T-ISS epoch. ``n_src < M`` adds the stationary unit-Gaussian
    background outputs (phi = 1), as in OverIVA-ISS."""
    P, Y = state
    T, F, MJ = Xt.shape
    M = n_chan
    MK = MJ - M
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

    for n in range(M):  # source steering: static unroll, order-dependent
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
        P = P - v[:, :, None] * P[:, n, :][:, None, :]

    if MK:
        Z = Xt[:, :, M:]  # (T, F, MK) delayed observations
        den_all = jnp.einsum(
            "tm,tfj->fmj", phif, jnp.abs(Z) ** 2, precision=PRECISION
        )  # (F, M, MK): hoisted out of the scan (depends only on phi)

        def tap_step(Yc, j):
            zj = lax.dynamic_index_in_dim(Z, j, axis=2, keepdims=False)
            num = jnp.einsum(
                "tm,tfm,tf->fm", phif, Yc, jnp.conj(zj), precision=PRECISION
            )
            den = lax.dynamic_index_in_dim(den_all, j, axis=2, keepdims=False)
            v = num / jnp.maximum(den, _EPS).astype(num.real.dtype)
            return Yc - v[None, :, :] * zj[:, :, None], v

        Y, vs = lax.scan(tap_step, Y, jnp.arange(MK))  # vs: (MK, F, M)
        P = P.at[:, :, M:].add(-jnp.moveaxis(vs, 0, 2))
    return P, Y


@partial(
    jax.jit,
    static_argnames=("n_iter", "model", "n_chan", "axis_name", "n_freq", "n_src"),
)
def tiss_iterations(
    Xt,
    P,
    n_iter: int,
    model: str,
    n_chan: int,
    axis_name=None,
    n_freq=None,
    bin_mask=None,
    n_src=None,
):
    """Run n_iter fused T-ISS epochs on the augmented input.

    Xt: (T, F, M + M*taps) from :func:`augment_taps`; P: (F, M, M + M*taps).
    Returns (P, Y) with the full M-output state; overdetermined callers take
    Y[:, :, :n_src]."""
    Y = demix(Xt, P)
    P, Y = lax.fori_loop(
        0,
        n_iter,
        lambda _, s: _tiss_epoch(
            Xt, s, model, n_chan, axis_name, n_freq, bin_mask, n_src
        ),
        (P, Y),
    )
    return P, Y
