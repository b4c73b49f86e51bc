"""T-ISS / T-IP at double-float (emulated f64) precision — ``acc="f32x2"``.

Why: tip is the thinnest-margin family on the 10-seed
hardware certification (0.061/0.027 dB vs the 0.1 gate, PARITY.md round
4) — the same complex64 trajectory-chaos floor the gauss family had
before `models/overiva_df.py`. This module extends the df certification
tier to the joint dereverberation + separation family: the ENTIRE
T-ISS / T-IP iteration — demixing, activations, steering sums, MJ-dim
weighted covariances, the dense augmented IP solve, normalizers, and
projection back — runs in double-float (f32x2) arithmetic
(~2^-48 relative precision, ops/df.py), scaling the chaotic-divergence
seed down by ~2^-24 relative to the plain c64 path.

Semantics mirror the oracles stage for stage (`oracle/tiss.py`,
`oracle/tip.py` — note the oracle T-IP uses the DENSE MJ-dim solve, not
the Schur reduction of `models/tip.py`; the df tier mirrors the oracle
because the oracle trajectory is the certification target). The only
deviations are dead-bin guards where the oracle's LAPACK would emit
inf/NaN; healthy bins are untouched.

Unlike `overiva_df` (M <= 8 unrolled bodies), the joint family's inner
loops run over M + M*taps augmented channels — up to 48 at the serving
config — so everything here is LOOP-FORM: `lax.scan` over steering
steps / IP rows and `lax.fori_loop` over solve pivots and contraction
dims. The unrolled form compiles for minutes at TOY sizes (measured
147 s at MJ=6 on CPU) and is intractable at MJ=48; the loop form is
value-identical (dynamic-index reads and where-masked row writes in the
same operation order).

This is the opt-in parity tier, not the performance path (~20x the
arithmetic of the f32 path). The augmented input stays as its EXACT f32
planes (frame-delay stacking is pad+slice — exact), entering df products
through the error-free ``cmul_pure``/``cprod_pure`` kernels exactly as
`overiva_df` does with the plain input.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.tree_util import tree_map

from ..ops import df
from ..ops.wpe import delayed_taps
from .overiva_df import (
    _activations_df,
    _concat,
    _czero,
    _slice,
    _sum_axis,
    _wcov_all_df,
)

__all__ = [
    "augment_planes",
    "eye_aug_df",
    "tiss_df_iterations",
    "tip_df_iterations",
    "finalize_from_y_df",
    "finalize_from_p_df",
    "planes_to_cdf",
]

_EPS = 1e-15  # the oracles' absolute floor (oracle/tiss.py, oracle/tip.py)


# ------------------------------------------------------------------ plumbing

@partial(jax.jit, static_argnames=("taps", "delay"))
def augment_planes(xr, xi, taps: int, delay: int):
    """(T, F, M) f32 planes -> (T, F, M + M*taps) augmented planes.

    Frame-delay stacking is pad + slice — EXACT on the separated planes,
    so the augmented input keeps hi = exact f32 plane, lo = 0."""
    if taps == 0:
        return xr, xi
    return (
        jnp.concatenate([xr, delayed_taps(xr, taps, delay)], axis=2),
        jnp.concatenate([xi, delayed_taps(xi, taps, delay)], axis=2),
    )


def planes_to_cdf(re, im):
    """Exact planes -> df complex pytree (lo = 0)."""
    return (df.from_float(re), df.from_float(im))


def cdf_to_planes(z):
    return df.to_float(z[0]), df.to_float(z[1])


def eye_aug_df(F: int, M: int, MJ: int):
    """df (F, M, MJ) with the instantaneous block = I, zero tap block —
    the shared joint-family init (oracle/tiss.py:78)."""
    e = jnp.zeros((F, M, MJ), jnp.float32).at[:, :, :M].set(
        jnp.eye(M, dtype=jnp.float32)
    )
    z = jnp.zeros_like(e)
    return (e, z), (z, z)


def _dyn(z, i, axis):
    """Dynamic-index every plane of a df tree along ``axis`` (drops it)."""
    return tree_map(
        lambda a: lax.dynamic_index_in_dim(a, i, axis, keepdims=False), z
    )


def _demix_block_loop(br, bi, W1):
    """Y[t,f,n] = sum_m W1[f,n,m] x[t,f,m], contraction as a fori_loop
    (the unrolled `overiva_df._demix_block` is intractable at MJ=48).
    Identical operation order: sequential adds m = 0..MJ-1."""
    T, F = br.shape[0], br.shape[1]
    MJ = br.shape[-1]
    N = W1[0][0].shape[1]

    def body(m, acc):
        Wm = _dyn(W1, m, 2)  # (F, N)
        Wm = tree_map(lambda x: x[None, :, :], Wm)
        t = df.cmul_pure(Wm, br[:, :, None, m], bi[:, :, None, m])
        return df.cadd(acc, t)

    # m = 0 term seeds the accumulator exactly (adding to a true zero df
    # is exact, so czero-seeded accumulation == the unrolled first term)
    return lax.fori_loop(0, MJ, body, _czero((T, F, N)))


def _cmatmul_loop(A, B):
    """df complex batched matmul (F,a,b) @ (F,b,c), contraction looped."""
    F, a_dim, b = A[0][0].shape
    c = B[0][0].shape[-1]

    def body(m, acc):
        Am = tree_map(lambda x: x[:, :, None], _dyn(A, m, 2))
        Bm = tree_map(lambda x: x[:, None, :], _dyn(B, m, 1))
        return df.cadd(acc, df.cmul(Am, Bm))

    return lax.fori_loop(0, b, body, _czero((F, a_dim, c)))


def _cmatvec_loop(A, v):
    """df complex (F,a,b) @ (F,b) -> (F,a), contraction looped."""
    F, a_dim, b = A[0][0].shape

    def body(m, acc):
        Am = _dyn(A, m, 2)  # (F, a)
        vm = tree_map(lambda x: x[:, None], _dyn(v, m, 1))
        return df.cadd(acc, df.cmul(Am, vm))

    return lax.fori_loop(0, b, body, _czero((F, a_dim)))


def _quad_form_re_loop(w, V):
    """Re(w^H V w) as df real (loop form of overiva_df._quad_form_re)."""
    t = _cmatvec_loop(V, w)  # (F, MJ)
    terms = df.add(df.mul(w[0], t[0]), df.mul(w[1], t[1]))
    return df.sum_tree(terms, 1)


def _gauss_solve_df_loop(A, B):
    """Batched Gauss-Jordan solve in df complex: A (F,m,m) X = B (F,m,r).

    Loop form of `overiva_df._gauss_solve_df` (value-identical: same
    pivot choice, same operation order per step — only the step index is
    traced). Partial pivoting by |.|^2 of the hi plane; dead pivots
    (exact zero) divide by 1 instead of NaN-ing."""
    F, m, _ = A[0][0].shape
    r = B[0][0].shape[-1]
    T = _concat([A, B], axis=2)  # augmented (F, m, m+r)
    rows = jnp.arange(m)

    def body(i, T):
        col = _dyn(T, i, 2)  # (F, m)
        mag = col[0][0] ** 2 + col[1][0] ** 2  # hi-plane |.|^2
        mag = jnp.where(rows[None, :] >= i, mag, -jnp.inf)
        p = jnp.argmax(mag, axis=1)  # (F,)
        idx = jnp.broadcast_to(rows[None, :], (F, m))
        idx = jnp.where(
            idx == i, p[:, None], jnp.where(idx == p[:, None], i, idx)
        )
        T = tree_map(lambda a: jnp.take_along_axis(a, idx[:, :, None], 1), T)
        piv = _dyn(T, i, 1)  # (F, m+r) row i
        a_ii = _dyn(piv, i, 1)  # (F,)
        dead = (a_ii[0][0] ** 2 + a_ii[1][0] ** 2) == 0.0
        safe = df.cwhere(
            dead,
            (df.from_float(jnp.ones_like(a_ii[0][0])),
             df.from_float(jnp.zeros_like(a_ii[0][0]))),
            a_ii,
        )
        piv = df.cdiv(piv, tree_map(lambda x: x[:, None], safe))
        fac = _dyn(T, i, 2)  # (F, m)
        prod = df.cmul(
            tree_map(lambda x: x[:, :, None], fac),
            tree_map(lambda x: x[:, None, :], piv),
        )
        newT = df.csub(T, prod)
        keep = (rows == i)[None, :, None]
        return df.cwhere(
            keep, tree_map(lambda x: x[:, None, :], piv), newT
        )

    T = lax.fori_loop(0, m, body, T)
    return _slice(T, (slice(None), slice(None), slice(m, m + r)))


def _phi_df(Y, M, N, n_freq, model):
    """Activations from the maintained df outputs' target rows, background
    rows padded with phi = 1 (oracle/tiss.py:98-100)."""
    Yt = _slice(Y, (slice(None), slice(None), slice(0, N)))
    pw = df.sum_tree(df.cabs2(Yt), 1)  # (T, N) real df
    _, phi = _activations_df(pw, n_freq, model)
    if N < M:
        ones = jnp.ones((phi[0].shape[0], M - N), jnp.float32)
        phi = (
            jnp.concatenate([phi[0], ones], axis=1),
            jnp.concatenate([phi[1], jnp.zeros_like(ones)], axis=1),
        )
    return phi


def _wnum_den(Y, phi, tgt_df=None, tgt_planes=None):
    """The steering-step statistics, in df:

        num[f, m] = sum_t phi[t, m] Y[t, f, m] conj(tgt[t, f])
        den[f, m] = sum_t phi[t, m] |tgt[t, f]|^2

    ``tgt`` is either a df complex (T, F) (a maintained output row) or the
    exact planes of a delayed-observation column."""
    if tgt_df is not None:
        tc = df.cconj(tgt_df)
        prod = df.cmul(Y, tree_map(lambda a: a[:, :, None], tc))
        ab = df.cabs2(tgt_df)  # (T, F) real df
    else:
        zr, zi = tgt_planes
        prod = df.cmul_pure(Y, zr[:, :, None], -zi[:, :, None])
        ab = df.cprod_pure(zr, zi, zr, -zi)[0]  # |z|^2, exact products
    w = tree_map(lambda a: a[:, None, :], phi)  # (T, 1, M) real df
    num = _sum_axis(df.cscale(prod, w), 0)  # (F, M) complex df
    den = df.sum_tree(
        df.mul(tree_map(lambda a: a[:, :, None], ab), w), 0
    )  # (F, M) real df
    return num, den


# -------------------------------------------------------------------- T-ISS

def _tiss_epoch_df(xtr, xti, state, M, N, n_freq, model):
    """One T-ISS epoch mirroring oracle/tiss.py:94-118 in df, with the
    source/tap steering steps as scans (loop-form note in the module
    docstring)."""
    P, Y = state
    T, F, MJ = xtr.shape
    MK = MJ - M
    phi = _phi_df(Y, M, N, n_freq, model)
    eps = df.const(_EPS)
    t_const = df.const(float(T))

    def source_body(carry, n):
        # source steering (order-dependent — scan keeps the order)
        P, Y = carry
        yn = _dyn(Y, n, 2)  # (T, F)
        num, den = _wnum_den(Y, phi, tgt_df=yn)
        v = df.cscale(num, df.recip(df.max_(den, eps)))  # (F, M)
        dnn = df.div(_dyn(den, n, 1), t_const)
        vnn = df.sub(
            df.from_float(jnp.ones_like(dnn[0])),
            df.recip(df.sqrt(df.max_(dnn, eps))),
        )
        col = jnp.arange(M)[None, :] == n
        vnn_c = (
            tree_map(lambda a: a[:, None], vnn),
            df.from_float(jnp.zeros_like(vnn[0][:, None])),
        )
        v = df.cwhere(col, vnn_c, v)
        Y = df.csub(
            Y,
            df.cmul(
                tree_map(lambda a: a[None, :, :], v),
                tree_map(lambda a: a[:, :, None], yn),
            ),
        )
        Pn = _dyn(P, n, 1)  # (F, MJ)
        P = df.csub(
            P,
            df.cmul(
                tree_map(lambda a: a[:, :, None], v),
                tree_map(lambda a: a[:, None, :], Pn),
            ),
        )
        return (P, Y), None

    (P, Y), _ = lax.scan(source_body, (P, Y), jnp.arange(M))
    if MK == 0:
        return P, Y

    colidx = jnp.arange(MJ)[None, None, :]

    def tap_body(carry, j):
        # tap steering: weighted LS against the delayed column, no self
        # term (the tap columns are not demixing outputs)
        P, Y = carry
        zr = lax.dynamic_index_in_dim(xtr, M + j, 2, keepdims=False)
        zi = lax.dynamic_index_in_dim(xti, M + j, 2, keepdims=False)
        num, den = _wnum_den(Y, phi, tgt_planes=(zr, zi))
        v = df.cscale(num, df.recip(df.max_(den, eps)))
        Y = df.csub(
            Y,
            df.cmul_pure(
                tree_map(lambda a: a[None, :, :], v),
                zr[:, :, None],
                zi[:, :, None],
            ),
        )
        newcol = df.csub(_dyn(P, M + j, 2), v)  # (F, M)
        mask = colidx == M + j
        P = tree_map(
            lambda a, c: jnp.where(mask, c[:, :, None], a), P, newcol
        )
        return (P, Y), None

    (P, Y), _ = lax.scan(tap_body, (P, Y), jnp.arange(MK))
    return P, Y


@partial(jax.jit, static_argnames=("model", "n_chan", "n_src"))
def tiss_df_iterations(xtr, xti, P, one, n_iter, model, n_chan, n_src):
    """Run ``n_iter`` (dynamic) df T-ISS epochs. xtr/xti: exact augmented
    planes (T, F, MJ); P: df (F, M, MJ). Returns (P, Y) with Y the
    MAINTAINED df outputs (the oracle returns its steered Y, not a
    recomputation — mirrored here for exact stage correspondence)."""
    M, N = n_chan, n_src
    F = xtr.shape[1]
    with df.fma_guard(one):
        Y = _demix_block_loop(xtr, xti, P)  # full M rows, (T, F, M)
        P, Y = lax.fori_loop(
            0,
            jnp.asarray(n_iter, jnp.int32),
            lambda _, s: _tiss_epoch_df(xtr, xti, s, M, N, F, model),
            (P, Y),
            unroll=False,
        )
    return P, Y


# --------------------------------------------------------------------- T-IP

def _tip_epoch_df(xtr, xti, P, M, N, n_freq, model, Vbg):
    """One T-IP epoch mirroring oracle/tip.py:111-129 in df: per row the
    DENSE MJ-dim weighted covariance + solve (the oracle's formulation —
    the Schur reduction of models/tip.py is a performance rewrite the
    certification tier deliberately does not take). Rows run as a scan;
    the solve pivots as a fori_loop (module docstring)."""
    T, F, MJ = xtr.shape
    Yt = _demix_block_loop(
        xtr, xti, _slice(P, (slice(None), slice(0, N), slice(None)))
    )
    pw = df.sum_tree(df.cabs2(Yt), 1)
    _, phi = _activations_df(pw, n_freq, model)
    eps = df.const(_EPS)
    rowsM = jnp.arange(M)[None, :, None]
    ek_base = jnp.arange(MJ)[None, :, None]

    def _v_target(k):
        phik = tree_map(lambda a: lax.dynamic_slice_in_dim(a, k, 1, 1), phi)
        return _wcov_all_df(xtr, xti, phik)[0]  # (F, MJ, MJ) df

    def row_body(P, k):
        if Vbg is not None:
            # phi = 1 rows (k >= N): V depends only on X_tilde — the
            # hoisted copy is the IDENTICAL computation (same op, same
            # input), so the mirror of the oracle's per-epoch einsum is
            # exact. cond compiles both branches once.
            V = lax.cond(k < N, _v_target, lambda _: Vbg, k)
        else:
            V = _v_target(k)
        PVtop = _cmatmul_loop(P, V)  # (F, M, MJ)
        Vbot = _slice(V, (slice(None), slice(M, None), slice(None)))
        PV = _concat([PVtop, Vbot], axis=1) if MJ > M else PVtop
        ek_hi = jnp.broadcast_to(ek_base == k, (F, MJ, 1)).astype(jnp.float32)
        ek_z = jnp.zeros_like(ek_hi)
        ek = ((ek_hi, ek_z), (ek_z, ek_z))
        w = _slice(
            _gauss_solve_df_loop(PV, ek), (slice(None), slice(None), 0)
        )
        denom = _quad_form_re_loop(w, V)  # (F,) real df
        scale = df.recip(df.sqrt(df.max_(denom, eps)))
        w = df.cscale(w, tree_map(lambda a: a[:, None], scale))
        row = df.cconj(w)  # (F, MJ)
        mask = rowsM == k
        P = tree_map(
            lambda a, rw: jnp.where(mask, rw[:, None, :], a), P, row
        )
        return P, None

    P, _ = lax.scan(row_body, P, jnp.arange(M))
    return P


@partial(jax.jit, static_argnames=("model", "n_chan", "n_src"))
def tip_df_iterations(xtr, xti, P, one, n_iter, model, n_chan, n_src):
    """Run ``n_iter`` (dynamic) df T-IP epochs on the augmented planes."""
    M, N = n_chan, n_src
    T, F, MJ = xtr.shape
    with df.fma_guard(one):
        if N < M:
            ones = (
                jnp.ones((T, 1), jnp.float32),
                jnp.zeros((T, 1), jnp.float32),
            )
            Vbg = _wcov_all_df(xtr, xti, ones)[0]
        else:
            Vbg = None
        P = lax.fori_loop(
            0,
            jnp.asarray(n_iter, jnp.int32),
            lambda _, p: _tip_epoch_df(xtr, xti, p, M, N, F, model, Vbg),
            P,
            unroll=False,
        )
    return P


# ----------------------------------------------------------------- finalize

def _proj_back_df(Y, x0r, x0i):
    """Projection back vs the ORIGINAL mic-0 planes, in df
    (oracle/projection.py semantics, mirrored from overiva_df.finalize_df)."""
    num = _sum_axis(df.cmul_pure(Y, x0r, -x0i), 0)  # (F, N)
    den = df.sum_tree(df.cabs2(Y), 0)  # (F, N) real df
    ok = den[0] > 0.0
    zre = df.where(ok, df.div(num[0], den),
                   df.from_float(jnp.ones_like(num[0][0])))
    zim = df.where(ok, df.div(num[1], den),
                   df.from_float(jnp.zeros_like(num[1][0])))
    zc = df.cconj((zre, zim))
    return df.cmul(Y, tree_map(lambda x: x[None, :, :], zc))


@partial(jax.jit, static_argnames=("n_src", "proj_back"))
def finalize_from_y_df(Y, x0r, x0i, one, n_src, proj_back):
    """T-ISS finalize: the oracle emits its MAINTAINED Y (oracle/tiss.py:120)
    — slice targets, project back, return f32 planes."""
    with df.fma_guard(one):
        Yt = _slice(Y, (slice(None), slice(None), slice(0, n_src)))
        if proj_back:
            Yt = _proj_back_df(Yt, x0r, x0i)
        return df.to_float(Yt[0]), df.to_float(Yt[1])


@partial(jax.jit, static_argnames=("n_src", "proj_back"))
def finalize_from_p_df(xtr, xti, P, x0r, x0i, one, n_src, proj_back):
    """T-IP finalize: the oracle RECOMPUTES Y = P X_tilde (oracle/tip.py:131)
    — demix target rows, project back, return f32 planes."""
    with df.fma_guard(one):
        Yt = _demix_block_loop(
            xtr, xti, _slice(P, (slice(None), slice(0, n_src), slice(None)))
        )
        if proj_back:
            Yt = _proj_back_df(Yt, x0r, x0i)
        return df.to_float(Yt[0]), df.to_float(Yt[1])
