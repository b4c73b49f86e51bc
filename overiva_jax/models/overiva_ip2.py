"""AuxIVA-IP2 / OverIVA-IP2 core — fused JAX iteration (trace-side).

Pairwise joint row updates (oracle twin ``overiva_jax/oracle/overiva_ip2.py``
— derivation, assignment convention and validation live there). Converges
3-5x faster per epoch than IP1 at small-to-moderate source counts; each
epoch sweeps all (i < j) target pairs, solving two (M, 2)-rhs systems and a
closed-form 2x2 generalized eigenproblem per pair, all in the bin-minor
layout (docs/DESIGN.md §2b). For N < M the orthogonal-constraint background
is re-imposed after every pair (SURVEY.md §2.3.3 convention).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.covariance import weighted_covariance_all
from ..ops.fminor import (
    clamp_pow2_fm,
    gauss_solve_fm,
    mat_h_fm,
    matmul_fm,
    quad_form_fm,
    replace_row,
    solve_mat_fm,
    to_fmajor,
    to_fminor,
)
from .overiva import demix
from .source_models import activations_from_power, power

__all__ = ["overiva_ip2_iterations", "_ip2_epoch"]

_EPS_DET = 1e-30


def _gevd_2x2_fm(B, A):
    """Generalized eigenpairs of B v = lam A v, Hermitian (2, 2, F) pencils.

    Returns (lam (2, F) ascending, V (2, 2, F) column eigenvectors). Same
    closed form as the oracle's ``_gevd_2x2`` (deterministic, so the
    LAPACK/XLA trajectories coincide)."""
    detA = A[0, 0] * A[1, 1] - A[0, 1] * A[1, 0]
    mag = jnp.abs(detA)
    detA = jnp.where(mag < _EPS_DET, _EPS_DET, detA)
    C00 = (A[1, 1] * B[0, 0] - A[0, 1] * B[1, 0]) / detA
    C01 = (A[1, 1] * B[0, 1] - A[0, 1] * B[1, 1]) / detA
    C10 = (-A[1, 0] * B[0, 0] + A[0, 0] * B[1, 0]) / detA
    C11 = (-A[1, 0] * B[0, 1] + A[0, 0] * B[1, 1]) / detA
    tr = C00 + C11
    det = C00 * C11 - C01 * C10
    disc = jnp.sqrt(tr * tr - 4.0 * det)
    lam = jnp.stack([(tr - disc) / 2, (tr + disc) / 2], axis=0)
    lam = jnp.real(lam)

    def vec(l):
        v1 = jnp.stack([C01, l - C00], axis=0)  # (2, F)
        v2 = jnp.stack([l - C11, C10], axis=0)
        use1 = (jnp.abs(C01) + jnp.abs(l - C00)) >= (
            jnp.abs(l - C11) + jnp.abs(C10)
        )
        return jnp.where(use1[None, :], v1, v2)

    V = jnp.stack([vec(lam[0]), vec(lam[1])], axis=1)  # (2, idx, F)
    return lam, V


def _pair_update(Wp, Vp_i, Vp_j, i: int, j: int):
    """Jointly update rows i, j of the bin-minor W (M, M, F)."""
    M, _, F = Wp.shape
    dtype = Wp.dtype
    E = jnp.zeros((M, 2), dtype).at[i, 0].set(1.0).at[j, 1].set(1.0)
    Et = jnp.broadcast_to(E[:, :, None], (M, 2, F))
    # clamp_pow2_fm: knife-edge bins give huge P whose Gram G = P^H V P
    # overflows f32 -> NaN; P's per-bin scale cancels exactly through the
    # generalized-eigen + _h normalization (w = P h), and a power-of-2
    # rescale is a bit-no-op on healthy bins
    P_i = clamp_pow2_fm(gauss_solve_fm(matmul_fm(Wp, Vp_i), Et))  # (M, 2, F)
    P_j = clamp_pow2_fm(gauss_solve_fm(matmul_fm(Wp, Vp_j), Et))
    G_i = matmul_fm(mat_h_fm(P_i), matmul_fm(Vp_i, P_i))  # (2, 2, F)
    G_j = matmul_fm(mat_h_fm(P_j), matmul_fm(Vp_j, P_j))
    _, Vv = _gevd_2x2_fm(G_j, G_i)

    def _h(v, G):
        # guarded normalizer (ops/fminor.quad_form_fm): an absolute floor
        # here amplified knife-edge bins by ~1e15 and collapsed the whole
        # instance through the joint activations (r3c m2_n2 regression)
        s, good = quad_form_fm(v, G)
        h = v / jnp.sqrt(
            jnp.where(good, s, 1.0)
        ).astype(v.real.dtype)[None, :]
        return h, good

    h_i, good_i = _h(Vv[:, 0, :], G_i)  # smaller-lam eigenvector -> src i
    h_j, good_j = _h(Vv[:, 1, :], G_j)
    # the GEVD couples the pair: if either Gram is rounding noise, both
    # candidate rows are garbage — keep the previous rows for those bins
    good = good_i & good_j
    w_i = jnp.sum(P_i * h_i[None, :, :], axis=1)  # (M, F)
    w_j = jnp.sum(P_j * h_j[None, :, :], axis=1)
    row_i = jnp.where(good[None, :], jnp.conj(w_i), Wp[i])
    row_j = jnp.where(good[None, :], jnp.conj(w_j), Wp[j])
    Wp = replace_row(Wp, i, row_i)
    return replace_row(Wp, j, row_j)


def _reimpose_oc(Wp, Cxp, n_src: int):
    """Background rows [J, -I] from the OC, scatter-free (bin-minor)."""
    M, _, F = Wp.shape
    N = n_src
    tmp = matmul_fm(Wp[:N], Cxp)  # (N, M, F)
    # a singular OC system (rank-deficient Cx) gives a huge J whose
    # next-epoch products overflow f32; J is garbage there either way —
    # keep it finite garbage (exact rescale, bit-no-op on healthy bins)
    J_H = clamp_pow2_fm(solve_mat_fm(tmp[:, :N, :], tmp[:, N:, :]))
    negI = jnp.broadcast_to(
        (-jnp.eye(M - N, dtype=Wp.dtype))[:, :, None], (M - N, M - N, F)
    )
    bottom = jnp.concatenate([mat_h_fm(J_H), negI], axis=1)
    return jnp.concatenate([Wp[:N], bottom], axis=0)


def _ip2_epoch(
    X, W_hat, Cx, n_src: int, model: str, axis_name=None, n_freq=None,
    bin_mask=None, wcov: str = "f32",
):
    """One IP2 epoch: weights + all-pairs joint updates (+ OC when N < M)."""
    T, F, M = X.shape
    N = n_src
    Y = demix(X, W_hat[:, :N, :])
    pw = power(Y, bin_mask)
    if axis_name is not None:
        pw = lax.psum(pw, axis_name)
    _, phi = activations_from_power(pw, n_freq or F, model)

    Vs = weighted_covariance_all(X, phi, wcov)  # (N, F, M, M)
    Vps = [to_fminor(Vs[k]) for k in range(N)]
    Wp = to_fminor(W_hat)
    Cxp = to_fminor(Cx) if N < M else None
    for i in range(N):  # static all-pairs sweep
        for j in range(i + 1, N):
            Wp = _pair_update(Wp, Vps[i], Vps[j], i, j)
            if N < M:
                Wp = _reimpose_oc(Wp, Cxp, N)
    return to_fmajor(Wp)


@partial(
    jax.jit,
    static_argnames=("n_src", "n_iter", "model", "axis_name", "n_freq", "wcov"),
)
def overiva_ip2_iterations(
    X, W_hat, Cx, n_src: int, n_iter: int, model: str,
    axis_name=None, n_freq=None, bin_mask=None, wcov: str = "f32",
):
    """Run n_iter fused IP2 epochs. X: (T,F,M); W_hat, Cx: (F,M,M).

    ``wcov="bf16"``: bfloat16 weighted-covariance stage (see
    ``ops.covariance.weighted_covariance_all``)."""
    return lax.fori_loop(
        0,
        n_iter,
        lambda _, W: _ip2_epoch(
            X, W, Cx, n_src, model, axis_name, n_freq, bin_mask, wcov
        ),
        W_hat,
        unroll=False,
    )
