"""T-IP core — joint dereverberation + separation with exact IP rows.

JAX twin of ``overiva_jax/oracle/tip.py`` (derivation, provenance, and the
measured warm-start requirement there). Per epoch and per source: one
MJ-dimensional weighted covariance of the augmented input (MJ = M + M*taps
— a sizeable (T, MJ) x (T, MJ) contraction per bin, unlike the
M<=8-tiny IVA wcov), the structured product [P; 0 I] @ V formed as a
(F, M, MJ) GEMM stacked on V's bottom rows (the identity block is free),
one batched MJ-dim :func:`gauss_solve`, and a scatter-free concat row
rebuild (docs/DESIGN.md §2b).

Sharding: bins are independent given phi — same single-psum family as
every other member (§3)."""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.covariance import weighted_covariance_all
from ..ops.linalg import PRECISION, clamp_pow2, gauss_solve
from .overiva import demix
from .source_models import activations_from_power, power
from .tiss import augment_taps  # noqa: F401  (re-export for callers)

__all__ = ["tip_iterations", "_tip_epoch", "augment_taps"]

_EPS = 1e-15


def _schur_pieces(V, n_chan: int):
    """Schur reduction of the structured T-IP system.

    P_tilde = [[P_top], [0, I]] is block upper-triangular in the
    augmented coordinates, so solving (P_tilde V) w = e_k (k < M) splits:
    the bottom block gives w2 = -V22^{-1} V21 w1 = -C w1, and substituting
    into the top block makes the tap coefficients of P_top CANCEL exactly
    (B V21 - B V22 C = 0), leaving the M-dim system

        A S w1 = e_k,   S = V11 - V12 C   (the Schur complement),
        A = P_top[:, :, :M].

    C and S depend only on V — for the background rows (phi = 1, k >= N)
    V is the plain augmented covariance, CONSTANT across the whole run,
    so their pieces are computed once in tip_iterations and reused.
    Returns (C (F, L, M), S (F, M, M))."""
    F = V.shape[0]
    M = n_chan
    L = V.shape[1] - M
    if L == 0:
        return jnp.zeros((F, 0, M), V.dtype), V
    C = gauss_solve(V[:, M:, M:], V[:, M:, :M])  # (F, L, M)
    S = V[:, :M, :M] - jnp.matmul(
        V[:, :M, M:], C, precision=PRECISION
    )
    return C, S


def _background_pieces(Xt, n_chan: int, wcov: str = "f32"):
    """Run-constant background-row quantities (phi = 1, so they depend
    only on X_tilde): the Schur pieces (C, S) of the plain augmented
    covariance. Returns (C, S).

    (A third piece was tried and rejected on measurement: computing the
    background normalizers from the tap-residual Z = x - C^H x_taps reads
    (T, F, M) instead of (T, F, MJ) per row, yet measured ~16% slower for
    the 10-epoch T=512/taps=5 polish on the first accelerator the system
    ran on; the narrower einsum lowered worse than the wide one it
    replaces. Not yet re-measured on the GPU.)"""
    ones = jnp.ones((Xt.shape[0], 1), Xt.real.dtype)
    Vbg = weighted_covariance_all(Xt, ones, wcov)[0]
    return _schur_pieces(Vbg, n_chan)


def _tip_epoch(
    Xt, P, model, n_chan, axis_name=None, n_freq=None, bin_mask=None,
    n_src=None, wcov: str = "f32", bg=None,
):
    """One T-IP epoch. Xt: (T, F, MJ); P: (F, M, MJ) top block.

    ``bg``: precomputed ``_background_pieces`` (C, S) of the background
    rows' (phi = 1) covariance — pass when n_src < n_chan to skip their
    per-epoch MJ-dim weighted covariance and solve entirely."""
    T, F, MJ = Xt.shape
    M = n_chan
    N = M if n_src is None else n_src
    # only the N target outputs feed the activations — don't demix the
    # background rows (M/N-fold waste on this X_tilde-read stage)
    Y = demix(Xt, P[:, :N, :])
    pw = power(Y, bin_mask)
    if axis_name is not None:
        pw = lax.psum(pw, axis_name)
    _, phi = activations_from_power(pw, n_freq or F, model)
    phif = phi.astype(Y.real.dtype)
    if N < M:
        phif = jnp.concatenate(
            [phif, jnp.ones((T, M - N), phif.dtype)], axis=1
        )

    for k in range(M):
        if k < N or bg is None:
            # MJ-dim weighted covariance — unlike the M<=8 IVA wcov this
            # is a sizeable product, so the bf16/f32x3 serving tiers of
            # ops/covariance.py apply (wcov="f32" is the exact parity
            # path). Deliberately PER SOURCE and DENSE: two alternatives
            # measured slower on the first accelerator at the 10-epoch
            # T=512/taps=5 polish — a batched all-N pass + K-stacked Schur
            # solve (the (N, F, MJ, MJ) temporary and reshape copies cost
            # more than the saved X_tilde reads), and frame-chunked
            # accumulation (the scan serializes). Not yet re-measured on
            # the GPU.
            V = weighted_covariance_all(Xt, phif[:, k : k + 1], wcov)[0]
            C, S = _schur_pieces(V, M)
        else:
            C, S = bg[0], bg[1]  # phi = 1 rows: run-constant pieces
        # M-dim Schur system instead of the dense MJ-dim solve
        AS = jnp.matmul(P[:, :, :M], S, precision=PRECISION)  # (F, M, M)
        rhs = jnp.zeros((F, M, 1), Xt.dtype).at[:, k, 0].set(1.0)
        w1 = gauss_solve(AS, rhs)[:, :, 0]  # (F, M)
        w2 = -jnp.einsum("flm,fm->fl", C, w1, precision=PRECISION)
        w = jnp.concatenate([w1, w2], axis=1)  # (F, MJ)
        # knife-edge guards (docs/DESIGN.md §4b): exact pow-2 clamp bounds
        # the solve output on near-singular bins, and the normalizer is
        # computed FROM THE DATA, not from V:
        #   w^H V w = (1/T) sum_t phi_t |w^H x_tilde|^2
        # — a sum of NON-NEGATIVE terms with zero cancellation. The
        # V-based quadratic form was tried first and is unusable at
        # MJ=48: legitimately deep nulls cancel it to rounding noise, so
        # a significant-bits gate froze healthy converged rows (a
        # systematic −2.4 dB median SIR at M=8), while the ungated form
        # amplified true dead bins ~1e19x and collapsed 6/20 instances
        # at 20 polish epochs. The data form resolves deep nulls down to
        # f32 underflow; only exactly-dead bins (denom == 0) keep the
        # previous row.
        w = clamp_pow2(w)
        yk = jnp.einsum("fa,tfa->tf", jnp.conj(w), Xt, precision=PRECISION)
        denom = (
            jnp.einsum(
                "t,tf->f", phif[:, k], jnp.abs(yk) ** 2, precision=PRECISION
            )
            / T
        )
        good = denom > 0.0
        w = w / jnp.sqrt(
            jnp.where(good, denom, 1.0)
        ).astype(w.real.dtype)[:, None]
        # re-clamp: an underflow-deep denominator could still push the
        # normalized row past f32 range (exact pow-2, healthy bins
        # untouched)
        w = clamp_pow2(w)
        row = jnp.where(good[:, None], jnp.conj(w), P[:, k, :])
        P = jnp.concatenate(
            [P[:, :k], row[:, None, :], P[:, k + 1 :]], axis=1
        )
    return P


@partial(
    jax.jit,
    static_argnames=(
        "n_iter", "model", "n_chan", "axis_name", "n_freq", "n_src", "wcov"
    ),
)
def tip_iterations(
    Xt,
    P,
    n_iter: int,
    model: str,
    n_chan: int,
    axis_name=None,
    n_freq=None,
    bin_mask=None,
    n_src=None,
    wcov: str = "f32",
):
    """Run n_iter fused T-IP epochs on the augmented input. Returns P.

    When overdetermined (n_src < n_chan) the background rows' phi = 1
    covariance and Schur pieces are hoisted out of the epoch loop: they
    depend only on Xt, so (M - N) of the M per-epoch MJ-dim weighted
    covariances + solves collapse into one one-time computation."""
    N = n_chan if n_src is None else n_src
    bg = _background_pieces(Xt, n_chan, wcov) if N < n_chan else None
    return lax.fori_loop(
        0,
        n_iter,
        lambda _, p: _tip_epoch(
            Xt, p, model, n_chan, axis_name, n_freq, bin_mask, n_src, wcov,
            bg,
        ),
        P,
    )
