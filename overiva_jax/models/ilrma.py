"""ILRMA core — fused JAX iteration (trace-side).

Accelerator re-design of the ``pyroomacoustics.bss.ilrma`` baseline the
reference sweeps against (SURVEY.md §2.1; Kitamura et al. 2016, ILRMA1).
Mirrors the NumPy oracle (``overiva_jax/oracle/ilrma.py``): per epoch and
per source, IS-NMF multiplicative updates of the rank-K variance model,
an iterative-projection update with per-(t,f) weights, and unit-power
rescaling. One XLA program for the whole run; the NMF matmuls
(F,K)@(K,T) batch naturally into matrix products, while the IP solve/normalize
machinery runs bin-minor (ops/fminor.py, docs/DESIGN.md §2b) and all
per-source state updates are scatter-free concat rebuilds.

Bin-sharded execution (``axis_name``): the NMF basis rows, the weighted
covariance, and the IP solve are bin-local; the activation update's
aggregates (two (K, T) sums over bins), and the unit-power rescale (one
scalar) are psum'd — H therefore stays bitwise-identical across shards.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.covariance import weighted_covariance_tf
from ..ops.fminor import (
    clamp_pow2_fm,
    gauss_solve_fm,
    matmul_fm,
    quad_form_fm,
    to_fminor,
)
from ..ops.linalg import PRECISION
from .overiva import demix

__all__ = ["ilrma_iterations", "_ilrma_epoch"]

_EPS = 1e-15


def _set_row(A, k, row):
    """Scatter-free static-index row replacement (docs/DESIGN.md §2b)."""
    return jnp.concatenate([A[:k], row[None], A[k + 1 :]], axis=0)


def _ilrma_epoch(X, state, axis_name=None, n_freq=None, bin_mask=None,
                 wcov: str = "f32"):
    """One ILRMA epoch. X: (T,F,M); state = (W (F,M,M), B (N,F,K), H (N,K,T))."""
    T, F, M = X.shape
    N = M
    F_total = n_freq or F
    W, B, H = state
    Y = demix(X, W)
    P = jnp.transpose(jnp.abs(Y) ** 2, (2, 1, 0))  # (N, F, T)
    mask = None if bin_mask is None else bin_mask.astype(P.dtype)[:, None]  # (F,1)
    Wp = to_fminor(W)  # (M, M, F) — bin-minor for the IP chain
    e = jnp.eye(M, dtype=X.dtype)

    for k in range(N):
        Pk = P[k]  # (F, T)
        Bk, Hk = B[k], H[k]
        R = jnp.matmul(Bk, Hk, precision=PRECISION) + _EPS

        # basis update: bin-local
        Bk = Bk * jnp.sqrt(
            jnp.matmul(Pk / R**2, Hk.T, precision=PRECISION)
            / (jnp.matmul(1.0 / R, Hk.T, precision=PRECISION) + _EPS)
        )
        Bk = jnp.maximum(Bk, _EPS)
        R = jnp.matmul(Bk, Hk, precision=PRECISION) + _EPS

        # activation update: aggregates over ALL bins (psum when sharded)
        hn = Pk / R**2
        hd = 1.0 / R
        if mask is not None:
            hn = hn * mask
            hd = hd * mask
        num = jnp.matmul(Bk.T, hn, precision=PRECISION)  # (K, T)
        den = jnp.matmul(Bk.T, hd, precision=PRECISION)
        if axis_name is not None:
            num = lax.psum(num, axis_name)
            den = lax.psum(den, axis_name)
        Hk = Hk * jnp.sqrt(num / (den + _EPS))
        Hk = jnp.maximum(Hk, _EPS)
        R = jnp.matmul(Bk, Hk, precision=PRECISION) + _EPS

        # IP update with per-(t,f) weights: bin-local, bin-minor machinery
        V = weighted_covariance_tf(X, (1.0 / R).T, wcov)
        Vp = to_fminor(V)  # (M, M, F)
        WV = matmul_fm(Wp, Vp)
        rhs = jnp.broadcast_to(e[:, k, None, None], (M, 1, F))
        w = gauss_solve_fm(WV, rhs)[:, 0, :]  # (M, F)
        w = clamp_pow2_fm(w)  # overflow guard, exact (see models/overiva.py)
        # guarded normalizer (see models/overiva.py): where the f32
        # quadratic form has no significant bits, keep the previous row
        # instead of writing an ~1e19x-amplified garbage one
        denom_r, good = quad_form_fm(w, Vp)
        w = w / jnp.sqrt(
            jnp.where(good, denom_r, 1.0)
        ).astype(w.real.dtype)[None, :]
        w = jnp.where(good[None, :], w, jnp.conj(Wp[k]))

        # unit-power rescale: global mean over (t, f)
        yk = jnp.einsum("mf,tfm->tf", jnp.conj(w), X, precision=PRECISION)
        p_yk = jnp.abs(yk) ** 2
        if mask is not None:
            p_yk = p_yk * mask.T
        s = jnp.sum(p_yk)
        if axis_name is not None:
            s = lax.psum(s, axis_name)
        lam = jnp.sqrt(s / (T * F_total)) + _EPS
        w = w / lam.astype(w.real.dtype)
        Wp = _set_row(Wp, k, jnp.conj(w))
        B = _set_row(B, k, Bk / (lam**2).astype(Bk.dtype))
        H = _set_row(H, k, Hk)
        # (P is NOT written back: every source reads only its own column,
        # and P is recomputed from the updated W at the next epoch start)

    return jnp.transpose(Wp, (2, 0, 1)), B, H


@partial(jax.jit, static_argnames=("n_iter", "wcov"))
def ilrma_iterations(X, W, B, H, n_iter: int, wcov: str = "f32"):
    """X: (T,F,M); W: (F,M,M); B: (N,F,K) >= 0; H: (N,K,T) >= 0.

    ``wcov="bf16"``: bfloat16 weighted covariance for the IP rows
    (ops.covariance.weighted_covariance_tf)."""
    W, B, H = lax.fori_loop(
        0, n_iter, lambda _, s: _ilrma_epoch(X, s, wcov=wcov), (W, B, H)
    )
    return W, B, H
