"""OverIVA / AuxIVA core — fused JAX iteration (trace-side).

Accelerator re-design of the reference's ``overiva.py`` hot loop (SURVEY.md
§2.3.2-3, §3.2): the whole run is ONE XLA program — ``lax.fori_loop`` over
epochs, a statically-unrolled loop over the (few) sources, and all
per-frequency linear algebra batched over bins. The reference pays Python
dispatch per source per epoch and materializes (T,F,M,M) intermediates;
here XLA fuses the phi-weighting into the covariance matmul and keeps
everything on-chip.

All functions are trace-side (complex in/out, jit-safe). The public
numpy-in/out API with callbacks lives in ``overiva_jax.api``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.covariance import covariance, weighted_covariance_all
from ..ops.fminor import (
    clamp_pow2_fm,
    gauss_solve_fm,
    mat_h_fm,
    matmul_fm,
    quad_form_fm,
    solve_mat_fm,
    to_fmajor,
    to_fminor,
    vecmat_fm,
)
from ..ops.linalg import (
    PRECISION,
    align_eigvec_phase,
    clamp_pow2,
    eigh,
    mat_h,
    solve_mat,
)
from .source_models import activations_from_power, power

__all__ = [
    "demix",
    "init_w_hat",
    "overiva_iterations",
    "overiva_run",
]


def demix(X, W1):
    """Y[t,f,n] = sum_m W1[f,n,m] X[t,f,m]."""
    return jnp.einsum("fnm,tfm->tfn", W1, X, precision=PRECISION)


def _update_J(W_hat, Cx, n_src: int, tmp=None):
    """Re-impose the orthogonal constraint (SURVEY.md §2.3.3):
    J = solve(tmp[:,:,:N], tmp[:,:,N:])^H with tmp = W1 @ Cx.

    ``tmp`` may be passed in by callers that maintain it incrementally
    (only the updated row of W1 changes it)."""
    N = n_src
    if tmp is None:
        W1 = W_hat[:, :N, :]
        tmp = jnp.matmul(W1, Cx, precision=PRECISION)  # (F, N, M)
    # clamp: singular OC -> huge J -> downstream f32 overflow (see _epoch)
    J_H = clamp_pow2(solve_mat(tmp[:, :, :N], tmp[:, :, N:]))  # (F, N, M-N)
    return W_hat.at[:, N:, :N].set(mat_h(J_H))


def init_w_hat(X, n_src: int, init_eig: bool, Cx=None, W0=None, dtype=None):
    """Initial structured demixing matrix W_hat (F, M, M).

    Identity target rows (or W0 rows, or top-eigenvector rows when
    ``init_eig``), [J, -I] background block, OC imposed once.
    """
    T, F, M = X.shape
    N = n_src
    dtype = dtype or X.dtype
    W_hat = jnp.tile(jnp.eye(M, dtype=dtype), (F, 1, 1))
    if N < M:
        W_hat = W_hat.at[:, N:, N:].set(-jnp.eye(M - N, dtype=dtype))

    if W0 is not None:
        W_hat = W_hat.at[:, :N, :].set(W0[:, :N, :] if W0.shape[1] == M else W0)
    elif init_eig:
        if Cx is None:
            Cx = covariance(X)
        _, vecs = eigh(Cx)  # ascending
        top = align_eigvec_phase(vecs[:, :, ::-1][:, :, :N])  # (F, M, N)
        W_hat = W_hat.at[:, :N, :].set(mat_h(top))

    if N < M:
        if Cx is None:
            Cx = covariance(X)
        W_hat = _update_J(W_hat, Cx, N)
    return W_hat


def _epoch(
    X,
    W_hat,
    Cx,
    n_src: int,
    model: str,
    axis_name=None,
    n_freq=None,
    bin_mask=None,
    chunk_frames=None,
    wcov: str = "f32",
):
    """One OverIVA/AuxIVA epoch: weights + N iterative-projection updates.

    ``axis_name``: when bins are sharded over a mesh axis, the per-frame
    power is psum'd over it — the only cross-shard collective (SURVEY.md
    §5.8). ``n_freq``: global bin count (needed by the gauss model when
    sharded); defaults to the local F. ``bin_mask`` zeroes padded bins'
    power contribution on sharded runs.
    """
    T, F, M = X.shape
    N = n_src
    Y = demix(X, W_hat[:, :N, :])
    pw = power(Y, bin_mask)  # (T, N) — partial when sharded
    if axis_name is not None:
        pw = lax.psum(pw, axis_name)
    _, phi = activations_from_power(pw, n_freq or F, model)

    # The update machinery runs in bin-minor layout (ops/fminor.py): F is
    # the contiguous axis of the (tiny, tiny, F) solve/normalize/OC
    # tensors. demix/wcov stay F-major (batched contractions are already
    # the fast form for them).
    Wp = to_fminor(W_hat)  # (M, M, F)
    Cxp = to_fminor(Cx) if N < M else None
    # tmp = W1 @ Cx for the OC update, maintained incrementally: each IP step
    # changes exactly one row of W1, so only that row of tmp is recomputed
    tmp = matmul_fm(Wp[:N], Cxp) if N < M else None  # (N, M, F)
    e = jnp.eye(M, dtype=X.dtype)

    def set_row(A, k, row):
        # static-index row replacement via concat: .at[k].set / strided
        # block .at[].set lower to scatters; concat of static slices is a
        # fused copy
        return jnp.concatenate([A[:k], row[None], A[k + 1 :]], axis=0)

    # all N weighted covariances up front (they depend only on the
    # epoch-start phi): one pass over X instead of N (X-read-bound op).
    # chunk_frames streams the frame axis (SURVEY.md §5.7): bounds the
    # (K, chunk, F, M) weighted temporary for long recordings
    Vs = weighted_covariance_all(X, phi, wcov, chunk=chunk_frames)
    for k in range(N):  # static unroll — IP updates are order-dependent
        V = Vs[k]  # (F, M, M)
        Vp = to_fminor(V)  # (M, M, F)
        WV = matmul_fm(Wp, Vp)
        rhs = jnp.broadcast_to(e[:, k, None, None], (M, 1, F))
        w = gauss_solve_fm(WV, rhs)[:, 0, :]  # (M, F)
        # knife-edge bins give a huge w whose quadratic form would overflow
        # f32 -> NaN; exact power-of-2 rescale (bit-no-op on healthy bins,
        # and the normalization below cancels any scale)
        w = clamp_pow2_fm(w)
        # guarded normalizer: on knife-edge bins the quadratic form
        # cancels to rounding noise (possibly <= 0); normalizing by it
        # amplifies the row by up to ~1e19 and the blow-up propagates to
        # every bin through the joint activations r within two epochs
        # (the r3c m2_n2 all-zero collapse). Where the form has no
        # significant bits, keep the previous row — the bin stays alive
        # and may recover once the other rows move.
        denom_r, good = quad_form_fm(w, Vp)
        w = w / jnp.sqrt(
            jnp.where(good, denom_r, 1.0)
        ).astype(w.real.dtype)[None, :]
        w = jnp.where(good[None, :], w, jnp.conj(Wp[k]))
        Wp = set_row(Wp, k, jnp.conj(w))
        if N < M:
            row = vecmat_fm(jnp.conj(w), Cxp)  # (M, F)
            tmp = set_row(tmp, k, row)
            # clamp: a singular OC system gives huge J -> next-epoch f32
            # overflow; finite garbage instead (bit-no-op on healthy bins)
            J_H = clamp_pow2_fm(
                solve_mat_fm(tmp[:, :N, :], tmp[:, N:, :])
            )  # (N, M-N, F)
            # rebuild the background rows [J, -I] with static concats (the
            # -I block is constant) instead of a strided block .at[].set
            negI = jnp.broadcast_to(
                (-jnp.eye(M - N, dtype=Wp.dtype))[:, :, None], (M - N, M - N, F)
            )
            bottom = jnp.concatenate([mat_h_fm(J_H), negI], axis=1)
            Wp = jnp.concatenate([Wp[:N], bottom], axis=0)
    return to_fmajor(Wp)


@partial(
    jax.jit,
    static_argnames=(
        "n_src", "n_iter", "model", "axis_name", "n_freq", "chunk_frames",
        "wcov",
    ),
)
def overiva_iterations(
    X,
    W_hat,
    Cx,
    n_src: int,
    n_iter: int,
    model: str,
    axis_name=None,
    n_freq=None,
    bin_mask=None,
    chunk_frames=None,
    wcov: str = "f32",
):
    """Run ``n_iter`` fused epochs. X: (T,F,M); W_hat: (F,M,M); Cx: (F,M,M).

    ``wcov`` selects the weighted-covariance tier (the dominant
    contraction) — see ``ops.covariance.weighted_covariance_all``."""
    return lax.fori_loop(
        0,
        n_iter,
        lambda _, W: _epoch(
            X, W, Cx, n_src, model, axis_name, n_freq, bin_mask, chunk_frames,
            wcov,
        ),
        W_hat,
        unroll=False,
    )


def overiva_run(X, n_src, n_iter, model, init_eig=False, W0=None):
    """Trace-side convenience: init + iterate + demix. Returns (Y, W_hat)."""
    T, F, M = X.shape
    Cx = covariance(X) if n_src < M or init_eig else jnp.zeros((F, M, M), X.dtype)
    W_hat = init_w_hat(X, n_src, init_eig, Cx=Cx, W0=W0)
    W_hat = overiva_iterations(X, W_hat, Cx, n_src, n_iter, model)
    Y = demix(X, W_hat[:, :n_src, :])
    return Y, W_hat
