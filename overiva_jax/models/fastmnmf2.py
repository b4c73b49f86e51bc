"""FastMNMF1/2 — fused JAX iteration (trace-side).

JAX twin of ``overiva_jax.oracle.fastmnmf2`` (Sekiguchi et al.,
jointly-diagonalizable full-rank spatial model; extension beyond the
reference repo — SURVEY.md §2.1 tops out at ILRMA). The spatial-weight
shape selects the variant everywhere: g (N, M) is FastMNMF2 (tied across
frequency, TASLP 2020), g (N, F, M) is FastMNMF1 (free per-frequency,
EUSIPCO 2019) — same epoch structure, different g einsum index and
reduction axes. One XLA program runs
``lax.fori_loop`` over epochs; each epoch is IS-NMF multiplicative updates
(pure elementwise/einsum), a multiplicative update of
the spatial weights g, and M sequential iterative-projection rows of the
shared diagonalizer Q with per-(t,f,m) weights 1/D, reusing the bin-minor
solve machinery of the IVA family (ops/fminor.py, docs/DESIGN.md §2b).

The update equations are locked to the oracle by the exact-likelihood
monotonicity property and a trajectory-level parity test
(tests/test_fastmnmf2.py).
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
    to_fmajor,
    to_fminor,
)
from ..ops.linalg import PRECISION

__all__ = [
    "fastmnmf2_iterations",
    "fastmnmf2_wiener",
    "unit_power",
    "whiten_q",
]

_EPS = 1e-10
_G_FLOOR = 1e-4  # spatial-weight floor; see the oracle's derivation note
# Floor on the modeled diagonalized power D (NOT the lam floor): the IS
# weights go as y/D^2, so D >= 1e-7 caps them at ~1e14 — safe in float32
# sums. At 1e-10, long runs (60+ epochs) overflow the f32 NMF statistics
# to NaN on WASPAA M=8 instances; the NumPy oracle masked this by
# computing D/S1/S2 in float64 even for complex64 input. With unit-power
# input scaling, 1e-7 is -70 dB — inactive except on silent slots.
_D_FLOOR = 1e-7


def unit_power(X):
    """(X / s, s) with s = sqrt(mean |X|^2): unit-mean-power input scale.

    The lam/D floors are absolute (1e-10), so with arbitrary input scale
    the floored y/D^2 terms can overflow float32 and the per-epoch Q<->W
    scale exchange ratchets to NaN (oracle docstring has the diagnosis).
    All entry points normalize with this helper and rescale the Wiener
    images back — exact by linearity.
    """
    s = jnp.sqrt(jnp.mean(jnp.abs(X) ** 2))
    s = jnp.where(s > 0, s, 1.0).astype(X.real.dtype)
    return X / s, s


def whiten_q(X):
    """Per-bin whitening basis Lam^{-1/2} E^H of the input covariance —
    the default Q init (identity init falls into non-separating local
    optima on most random mixtures; oracle docstring has the data)."""
    from ..ops.covariance import covariance
    from ..ops.linalg import align_eigvec_phase, eigh, mat_h

    ew, E = eigh(covariance(X))
    E = align_eigvec_phase(E)
    scale = jnp.sqrt(jnp.maximum(ew, 1e-12))[:, None, :].astype(E.real.dtype)
    return mat_h(E / scale)


def _psd(W, H):
    return jnp.maximum(
        jnp.einsum("nfl,nlt->nft", W, H, precision=PRECISION), _EPS
    )


def _g_sub(g):
    """einsum index of the spatial weights: (N,M) tied / (N,F,M) untied."""
    return "nm" if g.ndim == 2 else "nfm"


def _denom(lam, g):
    return jnp.maximum(
        jnp.einsum(f"nft,{_g_sub(g)}->tfm", lam, g, precision=PRECISION),
        _D_FLOOR,
    )


def _epoch(X, Q, g, W, H, axis_name=None, bin_mask=None, wcov: str = "f32",
           n_q_sweeps: int = 1):
    """One epoch. When bins are sharded over ``axis_name``, the only
    collectives are psums of the frequency-reduced NMF/spatial statistics
    (H and g numerators/denominators, the W normalizer) — everything else
    is per-bin local. ``bin_mask`` (F_local,) zeroes padded bins'
    contributions to those global sums."""
    T, F, M = X.shape

    def allsum(x):
        return x if axis_name is None else lax.psum(x, axis_name)

    def fmask(x):  # zero padded bins along axis 1 of an (n, F, ...) tensor
        if bin_mask is None:
            return x
        shape = [1] * x.ndim
        shape[1] = x.shape[1]
        return x * bin_mask.reshape(shape).astype(x.dtype)

    Qx = jnp.einsum("fmn,tfn->tfm", Q, X, precision=PRECISION)
    y = jnp.abs(Qx) ** 2  # (T, F, M) real

    gs = _g_sub(g)

    def weights(lam):
        D = _denom(lam, g)
        S1 = jnp.einsum(f"tfm,{gs}->nft", y / D**2, g, precision=PRECISION)
        S2 = jnp.einsum(f"tfm,{gs}->nft", 1.0 / D, g, precision=PRECISION)
        return D, S1, S2

    # ---- NMF basis W (per-frequency: local, no collectives) ----
    _, S1, S2 = weights(_psd(W, H))
    num = jnp.einsum("nft,nlt->nfl", S1, H, precision=PRECISION)
    den = jnp.einsum("nft,nlt->nfl", S2, H, precision=PRECISION)
    W = jnp.maximum(W * jnp.sqrt(num / jnp.maximum(den, _EPS)), _EPS)

    # ---- NMF activations H (sums over ALL bins: one psum pair) ----
    _, S1, S2 = weights(_psd(W, H))
    num = allsum(jnp.einsum("nft,nfl->nlt", fmask(S1), W, precision=PRECISION))
    den = allsum(jnp.einsum("nft,nfl->nlt", fmask(S2), W, precision=PRECISION))
    H = jnp.maximum(H * jnp.sqrt(num / jnp.maximum(den, _EPS)), _EPS)

    # ---- spatial weights g: tied sums over all bins and frames (one psum
    # pair); untied (FastMNMF1) is per-frequency — local, no collectives ----
    lam = _psd(W, H)
    D = _denom(lam, g)
    if g.ndim == 2:
        num = allsum(
            jnp.einsum("nft,tfm->nm", fmask(lam), y / D**2, precision=PRECISION)
        )
        den = allsum(
            jnp.einsum("nft,tfm->nm", fmask(lam), 1.0 / D, precision=PRECISION)
        )
    else:
        num = jnp.einsum("nft,tfm->nfm", lam, y / D**2, precision=PRECISION)
        den = jnp.einsum("nft,tfm->nfm", lam, 1.0 / D, precision=PRECISION)
    g = jnp.maximum(g * jnp.sqrt(num / jnp.maximum(den, _EPS)), _G_FLOOR)

    # ---- diagonalizer rows: sequential IP with weights 1/D (D fixed) ----
    # V_m depends only on D, not Q, so extra sweeps (n_q_sweeps > 1 —
    # heavier per-epoch Q optimization on the same MM surrogate) reuse the
    # covariances: the dominant wcov stage is paid once per epoch.
    lam = _psd(W, H)
    D = _denom(lam, g)
    Qp = to_fminor(Q)  # (M, M, F)
    e = jnp.eye(M, dtype=X.dtype)
    Vps = [
        to_fminor(weighted_covariance_tf(X, 1.0 / D[:, :, m], wcov))
        for m in range(M)
    ]
    for _ in range(n_q_sweeps):
        for m in range(M):  # static unroll — rows are order-dependent via Q
            Vp = Vps[m]
            QV = matmul_fm(Qp, Vp)
            rhs = jnp.broadcast_to(e[:, m, None, None], (M, 1, F))
            q = gauss_solve_fm(QV, rhs)[:, 0, :]  # (M, F)
            q = clamp_pow2_fm(q)  # overflow guard, exact (models/overiva.py)
            # guarded normalizer (see models/overiva.py / DESIGN.md §4b):
            # where the f32 quadratic form cancels to rounding noise, keep
            # the previous row instead of amplifying a garbage one
            nrm, good = quad_form_fm(q, Vp)
            q = q / jnp.sqrt(
                jnp.where(good, jnp.maximum(nrm, _EPS), 1.0)
            ).astype(q.real.dtype)
            q = jnp.where(good[None, :], q, jnp.conj(Qp[m]))
            # static-index row replacement (scatter-free — DESIGN.md §2b)
            Qp = jnp.concatenate(
                [Qp[:m], jnp.conj(q)[None], Qp[m + 1 :]], axis=0
            )
    Q = to_fmajor(Qp)

    # ---- likelihood-invariant normalization (nu sums over all bins) ----
    phi = jnp.real(jnp.einsum("fmn,fmn->f", Q, jnp.conj(Q))) / M
    Q = Q / jnp.sqrt(phi)[:, None, None].astype(Q.real.dtype)
    W = W / phi[None, :, None]
    mu = jnp.sum(g, axis=-1, keepdims=True)  # (N,1) tied / (N,F,1) untied
    g = g / mu
    W = W * (mu if g.ndim == 3 else mu[:, :, None])
    nu = jnp.maximum(
        allsum(jnp.sum(fmask(W), axis=1, keepdims=True)), _EPS
    )  # (N, 1, L)
    W = W / nu
    H = H * jnp.transpose(nu, (0, 2, 1))
    return Q, g, W, H


@partial(jax.jit, static_argnames=("n_iter", "axis_name", "wcov",
                                   "n_q_sweeps"))
def fastmnmf2_iterations(
    X, Q, g, W, H, n_iter: int, axis_name=None, bin_mask=None,
    wcov: str = "f32", n_q_sweeps: int = 1,
):
    """Run ``n_iter`` fused epochs. X: (T,F,M) complex; Q: (F,M,M);
    g: (N,M) tied / (N,F,M) untied; W: (N,F,L); H: (N,L,T).
    ``axis_name``/``bin_mask``: bin sharding (see ``_epoch``)."""
    return lax.fori_loop(
        0,
        n_iter,
        lambda _, s: _epoch(X, *s, axis_name=axis_name, bin_mask=bin_mask,
                            wcov=wcov, n_q_sweeps=n_q_sweeps),
        (Q, g, W, H),
        unroll=False,
    )


@partial(jax.jit, static_argnames=("mic_index",))
def fastmnmf2_wiener(X, Q, g, W, H, mic_index: int = 0):
    """Multichannel Wiener source images at one mic: (T, F, N) complex.

    x_hat[n] = (Q^{-1} diag(lam_n g_n / D) Q x)[mic_index].
    """
    T, F, M = X.shape
    Qx = jnp.einsum("fmn,tfn->tfm", Q, X, precision=PRECISION)
    lam = _psd(W, H)
    D = _denom(lam, g)
    # row ``mic_index`` of Q^{-1}: solve Q^T r = e_mic
    e = jnp.zeros((M,), Q.dtype).at[mic_index].set(1.0)
    Qt = to_fminor(jnp.swapaxes(Q, 1, 2))
    r = gauss_solve_fm(Qt, jnp.broadcast_to(e[:, None, None], (M, 1, F)))
    r = jnp.swapaxes(r[:, 0, :], 0, 1)  # (F, M)
    # gain[n][t,f,m] = lam[n,f,t] g[n,(f,)m] / D[t,f,m]
    gb = g[:, None, None, :] if g.ndim == 2 else g[:, None, :, :]
    gain = (
        jnp.transpose(lam, (0, 2, 1))[:, :, :, None]  # (N, T, F, 1)
        * gb  # (N, 1, 1, M) tied / (N, 1, F, M) untied
        / D[None]  # (1, T, F, M)
    )
    return jnp.einsum(
        "fm,ntfm->tfn", r, gain * Qx[None], precision=PRECISION
    )
