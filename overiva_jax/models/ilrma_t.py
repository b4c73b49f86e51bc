"""ILRMA-T core — joint dereverberation + ILRMA, fused JAX iteration.

JAX twin of ``overiva_jax/oracle/ilrma_t.py`` (derivation and provenance
there): the ILRMA rank-K NMF variance model driving T-ISS rank-1 steering
on the augmented input [X | delayed taps]. Structure per epoch:

- per-source IS-NMF multiplicative updates (basis bin-local; activation
  aggregates psum'd over bins when sharded — as ``models/ilrma.py``);
- M source-steering + M*taps tap-steering rank-1 updates with the
  PER-(t,f) weights phi = 1/(B H) — unlike IVA's per-frame weights these
  are bin-local, so the steering needs NO collective at all; the tap
  denominators are hoisted out of the scan exactly as ``models/tiss.py``;
- ILRMA1 unit-power renormalization per source (one psum'd scalar).

No solves anywhere: the NMF matmuls and steering contractions are all
einsums over the frame axis.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.linalg import PRECISION
from .tiss import augment_taps  # noqa: F401  (re-export for callers)

__all__ = ["ilrma_t_iterations", "_ilrma_t_epoch", "augment_taps"]

_EPS = 1e-15


def _set_row(A, k, row):
    """Scatter-free static-index row replacement (docs/DESIGN.md §2b)."""
    return jnp.concatenate([A[:k], row[None], A[k + 1 :]], axis=0)


def _ilrma_t_epoch(
    Xt, state, n_chan, axis_name=None, n_freq=None, bin_mask=None
):
    """One ILRMA-T epoch.

    Xt: (T, F, M + M*taps) augmented input; state = (P (F, M, M+MK),
    Y (T, F, M), B (M, F, K), H (M, K, T))."""
    P, Y, B, H = state
    T, F, MJ = Xt.shape
    M = n_chan
    MK = MJ - M
    F_total = n_freq or F
    rdt = Y.real.dtype
    mask = None if bin_mask is None else bin_mask.astype(rdt)[:, None]  # (F,1)

    # ---- NMF updates (per source; H aggregates over all bins)
    Pw = jnp.transpose(jnp.abs(Y) ** 2, (2, 1, 0))  # (M, F, T)
    for k in range(M):
        Pk = Pw[k]
        Bk, Hk = B[k], H[k]
        R = jnp.matmul(Bk, Hk, precision=PRECISION) + _EPS
        Bk = Bk * jnp.sqrt(
            jnp.matmul(Pk / R**2, Hk.T, precision=PRECISION)
            / (jnp.matmul(1.0 / R, Hk.T, precision=PRECISION) + _EPS)
        )
        Bk = jnp.maximum(Bk, _EPS)
        R = jnp.matmul(Bk, Hk, precision=PRECISION) + _EPS
        hn, hd = Pk / R**2, 1.0 / R
        if mask is not None:
            hn, hd = hn * mask, hd * mask
        num = jnp.matmul(Bk.T, hn, precision=PRECISION)
        den = jnp.matmul(Bk.T, hd, precision=PRECISION)
        if axis_name is not None:
            num = lax.psum(num, axis_name)
            den = lax.psum(den, axis_name)
        Hk = jnp.maximum(Hk * jnp.sqrt(num / (den + _EPS)), _EPS)
        B = _set_row(B, k, Bk)
        H = _set_row(H, k, Hk)

    # per-(t, f, k) weights — bin-local, no collective for the steering
    phi = 1.0 / (
        jnp.einsum("nfk,nkt->tfn", B, H, precision=PRECISION) + _EPS
    )
    phi = phi.astype(rdt)

    for n in range(M):  # source steering, f-resolved weights
        yn = Y[:, :, n]
        num = jnp.einsum(
            "tfm,tfm,tf->fm", phi, Y, jnp.conj(yn), precision=PRECISION
        )
        den = jnp.einsum(
            "tfm,tf->fm", phi, jnp.abs(yn) ** 2, precision=PRECISION
        )
        v = num / jnp.maximum(den, _EPS).astype(num.real.dtype)
        dnn = den[:, n] / T
        vnn = 1.0 - jax.lax.rsqrt(jnp.maximum(dnn, _EPS))
        col = jnp.arange(M)[None, :] == n
        v = jnp.where(col, vnn.astype(v.real.dtype)[:, None], v)
        Y = Y - v[None, :, :] * yn[:, :, None]
        P = P - v[:, :, None] * P[:, n, :][:, None, :]

    if MK:
        Z = Xt[:, :, M:]  # (T, F, MK)
        den_all = jnp.einsum(
            "tfm,tfj->fmj", phi, jnp.abs(Z) ** 2, precision=PRECISION
        )

        def tap_step(Yc, j):
            zj = lax.dynamic_index_in_dim(Z, j, axis=2, keepdims=False)
            num = jnp.einsum(
                "tfm,tfm,tf->fm", phi, Yc, jnp.conj(zj), precision=PRECISION
            )
            den = lax.dynamic_index_in_dim(den_all, j, axis=2, keepdims=False)
            v = num / jnp.maximum(den, _EPS).astype(num.real.dtype)
            return Yc - v[None, :, :] * zj[:, :, None], v

        Y, vs = lax.scan(tap_step, Y, jnp.arange(MK))
        P = P.at[:, :, M:].add(-jnp.moveaxis(vs, 0, 2))

    # ILRMA1 unit-power renormalization (likelihood-invariant)
    p = jnp.abs(Y) ** 2
    if mask is not None:
        p = p * mask[None]
    s = jnp.sum(p, axis=(0, 1))  # (M,)
    if axis_name is not None:
        s = lax.psum(s, axis_name)
    lam = jnp.sqrt(s / (T * F_total)) + _EPS
    Y = Y / lam[None, None, :].astype(rdt)
    P = P / lam[None, :, None].astype(rdt)
    B = B / (lam**2)[:, None, None].astype(B.dtype)
    return P, Y, B, H


@partial(
    jax.jit,
    static_argnames=("n_iter", "n_chan", "axis_name", "n_freq"),
)
def ilrma_t_iterations(
    Xt, P, B, H, n_iter: int, n_chan: int, axis_name=None, n_freq=None,
    bin_mask=None,
):
    """Run n_iter fused ILRMA-T epochs on the augmented input.

    Xt: (T, F, M + M*taps); P: (F, M, M + M*taps); B: (M, F, K) >= 0;
    H: (M, K, T) >= 0. Returns (P, Y, B, H)."""
    from .overiva import demix

    Y = demix(Xt, P)
    return lax.fori_loop(
        0,
        n_iter,
        lambda _, s: _ilrma_t_epoch(Xt, s, n_chan, axis_name, n_freq, bin_mask),
        (P, Y, B, H),
    )
