"""OverIVA / AuxIVA at double-float (emulated f64) precision — `acc="f32x2"`.

Why this exists: the gauss-model family's hardware parity floor is the
complex64 precision itself, and the round-4 stage-isolation experiment
(bench/exp_gauss_floor.py, PARITY.md) showed no single stage is the
amplifier — only promoting EVERYTHING after the one-time c64 input cast
reproduces the f64 oracle (0.0000 dB). For hardware without fast float64,
this module runs the ENTIRE iteration — demix, activations, weighted
covariances, IP solves, normalizers, the OC update, and projection back —
in double-float (f32x2) arithmetic (~2^-48 relative precision,
ops/df.py), scaling the chaotic-divergence seed down by ~2^-24 relative
to the plain c64 path.

Semantics mirror the oracle (`oracle/overiva.py`) stage for stage; the
only deviations are NaN guards on dead bins (where the oracle's LAPACK
solve would produce inf/NaN garbage) — healthy bins are untouched.

This is the opt-in parity tier, not the performance path: every complex
multiply costs ~20 f32 ops. Use it to certify hardware results
against the f64 oracle (examples/parity_check.py --acc f32x2), or
wherever f64-grade numerics matter more than speed.

Representation: a df complex array is ``((re_hi, re_lo), (im_hi, im_lo))``
of same-shape f32 arrays — a JAX pytree, so it flows through
``lax.fori_loop`` carries and jit boundaries unchanged. The input STFT
enters as its exact c64 planes (hi = f32 plane, lo = 0).
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.tree_util import tree_map

from ..ops import df
from ..oracle.models import EPS, REL_EPS

__all__ = [
    "covariance_df",
    "init_w_hat_df",
    "overiva_df_iterations",
    "finalize_df",
]


# ------------------------------------------------------------- small helpers

def _czero(shape):
    z = jnp.zeros(shape, jnp.float32)
    return (z, jnp.zeros_like(z)), (jnp.zeros_like(z), jnp.zeros_like(z))


def _ceye(F, M):
    """df complex identity tiled over F: (F, M, M)."""
    e = jnp.broadcast_to(jnp.eye(M, dtype=jnp.float32), (F, M, M))
    z = jnp.zeros_like(e)
    return (e, z), (z, z)


def _slice(z, sl):
    return tree_map(lambda a: a[sl], z)


def _concat(zs, axis):
    return tree_map(lambda *leaves: jnp.concatenate(leaves, axis=axis), *zs)


def _sum_axis(z, axis):
    """Pairwise-tree df reduce of a df complex array along ``axis``."""
    return (df.sum_tree(z[0], axis), df.sum_tree(z[1], axis))


def _cmatmul(A, B):
    """df complex batched matmul: (F,a,b) @ (F,b,c) -> (F,a,c).

    Unrolled over the small contraction dim (b <= M <= ~8): each term is a
    broadcast df cmul over (F,a,c)."""
    b = A[0][0].shape[-1]
    acc = None
    for m in range(b):
        Am = _slice(A, (slice(None), slice(None), m))  # (F,a)
        Bm = _slice(B, (slice(None), m, slice(None)))  # (F,c)
        Am = tree_map(lambda x: x[:, :, None], Am)
        Bm = tree_map(lambda x: x[:, None, :], Bm)
        t = df.cmul(Am, Bm)
        acc = t if acc is None else df.cadd(acc, t)
    return acc


def _cmatvec(A, v):
    """(F,a,b) @ (F,b) -> (F,a)."""
    b = A[0][0].shape[-1]
    acc = None
    for m in range(b):
        Am = _slice(A, (slice(None), slice(None), m))
        vm = tree_map(lambda x: x[:, None], _slice(v, (slice(None), m)))
        t = df.cmul(Am, vm)
        acc = t if acc is None else df.cadd(acc, t)
    return acc


def _gauss_solve_df(A, B):
    """Batched Gauss-Jordan solve in df complex: A (F,m,m) X = B (F,m,r).

    Partial pivoting by |.|^2 of the hi plane (pivot CHOICE only affects
    stability, not the computed-value semantics); physical row swaps via
    take_along_axis on the four planes. Dead pivots (exact zero) divide by
    1 instead of NaN-ing — the oracle's LAPACK would error there; healthy
    bins are identical.
    """
    F, m, _ = A[0][0].shape
    r = B[0][0].shape[-1]
    T = _concat([A, B], axis=2)  # augmented (F, m, m+r)
    rows = jnp.arange(m)
    for i in range(m):
        col = _slice(T, (slice(None), slice(None), i))  # (F, m)
        mag = col[0][0] ** 2 + col[1][0] ** 2  # hi-plane |.|^2
        mag = jnp.where(rows[None, :] >= i, mag, -jnp.inf)
        p = jnp.argmax(mag, axis=1)  # (F,)
        # permutation swapping rows i <-> p, per batch element
        idx = jnp.broadcast_to(rows[None, :], (F, m))
        idx = jnp.where(idx == i, p[:, None], jnp.where(
            idx == p[:, None], i, idx))
        T = tree_map(lambda a: jnp.take_along_axis(a, idx[:, :, None], 1), T)
        piv = _slice(T, (slice(None), i, slice(None)))  # (F, m+r) row i
        a_ii = _slice(T, (slice(None), i, i))  # (F,)
        dead = (a_ii[0][0] ** 2 + a_ii[1][0] ** 2) == 0.0
        safe = df.cwhere(
            dead,
            (df.from_float(jnp.ones_like(a_ii[0][0])),
             df.from_float(jnp.zeros_like(a_ii[0][0]))),
            a_ii,
        )
        piv = df.cdiv(piv, tree_map(lambda x: x[:, None], safe))
        # eliminate column i from every other row
        fac = _slice(T, (slice(None), slice(None), i))  # (F, m)
        prod = df.cmul(
            tree_map(lambda x: x[:, :, None], fac),
            tree_map(lambda x: x[:, None, :], piv),
        )  # (F, m, m+r)
        newT = df.csub(T, prod)
        keep = (rows == i)[None, :, None]
        T = df.cwhere(
            keep, tree_map(lambda x: x[:, None, :], piv), newT
        )
    return _slice(T, (slice(None), slice(None), slice(m, m + r)))


def _chunk_frames(T, chunk):
    c = min(chunk, T)
    n = -(-T // c)
    return c, n, n * c - T


def _xh_prod(xr, xi):
    """Exact outer products x x^H for a frame block: (Tc,F,M,M) df."""
    return df.cprod_pure(
        xr[:, :, :, None], xi[:, :, :, None],
        xr[:, :, None, :], -xi[:, :, None, :],
    )


def covariance_df(xr, xi, chunk=16):
    """Cx = (1/T) sum_t x x^H in df: (F, M, M). Exact products, pairwise
    df accumulation within chunks, sequential df adds across chunks."""
    T, F, M = xr.shape
    c, n, pad = _chunk_frames(T, chunk)
    if pad:
        xr = jnp.pad(xr, ((0, pad), (0, 0), (0, 0)))
        xi = jnp.pad(xi, ((0, pad), (0, 0), (0, 0)))
    xr = xr.reshape(n, c, F, M)
    xi = xi.reshape(n, c, F, M)

    def body(acc, blk):
        br, bi = blk
        part = _sum_axis(_xh_prod(br, bi), 0)
        return df.cadd(acc, part), None

    acc, _ = lax.scan(body, _czero((F, M, M)), (xr, xi))
    invT = df.recip(df.from_float(jnp.float32(T)))
    return df.cscale(acc, invT)


def _demix_pw(xr, xi, W1, chunk=64):
    """Per-frame power pw (T, N) df of Y = W1 demix(X) without keeping Y."""
    T, F, M = xr.shape
    N = W1[0][0].shape[1]
    c, n, pad = _chunk_frames(T, chunk)
    if pad:
        xr = jnp.pad(xr, ((0, pad), (0, 0), (0, 0)))
        xi = jnp.pad(xi, ((0, pad), (0, 0), (0, 0)))
    xr = xr.reshape(n, c, F, M)
    xi = xi.reshape(n, c, F, M)

    def body(_, blk):
        br, bi = blk
        Y = _demix_block(br, bi, W1)
        pw = df.sum_tree(df.cabs2(Y), 1)  # over F -> (c, N)
        return None, pw

    _, pws = lax.scan(body, None, (xr, xi))
    pw = tree_map(lambda a: a.reshape(n * c, N)[:T], pws)
    return pw


def _demix_block(br, bi, W1):
    """Y[t,f,n] = sum_m W1[f,n,m] x[t,f,m] for a frame block (c,F,M)."""
    M = br.shape[-1]
    acc = None
    for m in range(M):
        Wm = _slice(W1, (slice(None), slice(None), m))  # (F, N)
        Wm = tree_map(lambda x: x[None, :, :], Wm)
        t = df.cmul_pure(Wm, br[:, :, None, m], bi[:, :, None, m])
        acc = t if acc is None else df.cadd(acc, t)
    return acc  # (c, F, N) df


def _activations_df(pw, n_freq, model):
    """r and phi = 1/r from the per-frame power, mirroring oracle/models.py
    (absolute EPS floor + REL_EPS relative floor, PARITY.md row 13)."""
    if model == "gauss":
        r = df.div(pw, df.from_float(jnp.float32(n_freq)))
    elif model == "laplace":
        r = df.mul_f(df.sqrt(pw), jnp.float32(2.0))
    else:
        raise ValueError(f"unknown source model {model!r}")
    eps = df.const(EPS)
    r = df.max_(r, tree_map(lambda x: jnp.broadcast_to(x, r[0].shape),
                            (eps[0], eps[1])))
    rmax = df.max_tree(r, 0)  # (N,)
    thr = df.mul(df.const(REL_EPS), rmax)
    r = df.max_(r, tree_map(lambda x: jnp.broadcast_to(x[None, :],
                                                       r[0].shape), thr))
    return r, df.recip(r)


def _wcov_all_df(xr, xi, phi, chunk=16):
    """All N weighted covariances V_k = (1/T) sum_t phi[t,k] x x^H in df.

    One pass over X per chunk: the exact x x^H block is shared by the N
    phi-weightings (same single-X-read structure as the f32 path)."""
    T, F, M = xr.shape
    N = phi[0].shape[1]
    c, n, pad = _chunk_frames(T, chunk)
    if pad:
        xr = jnp.pad(xr, ((0, pad), (0, 0), (0, 0)))
        xi = jnp.pad(xi, ((0, pad), (0, 0), (0, 0)))
        phi = tree_map(lambda a: jnp.pad(a, ((0, pad), (0, 0))), phi)
    xr = xr.reshape(n, c, F, M)
    xi = xi.reshape(n, c, F, M)
    phi = tree_map(lambda a: a.reshape(n, c, N), phi)

    def body(accs, blk):
        br, bi, ph, pl = blk
        prod = _xh_prod(br, bi)  # (c, F, M, M) df complex
        outs = []
        for k in range(N):
            w = (ph[:, None, None, None, k], pl[:, None, None, None, k])
            part = _sum_axis(df.cscale(prod, w), 0)
            outs.append(df.cadd(accs[k], part))
        return tuple(outs), None

    init = tuple(_czero((F, M, M)) for _ in range(N))
    accs, _ = lax.scan(body, init, (xr, xi, phi[0], phi[1]))
    invT = df.recip(df.from_float(jnp.float32(T)))
    return [df.cscale(V, invT) for V in accs]


def _quad_form_re(w, V):
    """Re(w^H V w) as df real: (F,) from w (F,M), V (F,M,M)."""
    t = _cmatvec(V, w)  # (F, M)
    # Re(conj(w) . t) = wr*tr + wi*ti, summed over M in df
    terms = df.add(df.mul(w[0], t[0]), df.mul(w[1], t[1]))
    return df.sum_tree(terms, 1)


def _update_j_df(W, Cx, n_src):
    """Re-impose the orthogonal constraint in df (oracle/_update_J):
    tmp = W1 @ Cx; J_H = solve(tmp[:,:,:N], tmp[:,:,N:]); rows [J, -I]."""
    F, M, _ = W[0][0].shape
    N = n_src
    W1 = _slice(W, (slice(None), slice(0, N), slice(None)))
    tmp = _cmatmul(W1, Cx)  # (F, N, M)
    A = _slice(tmp, (slice(None), slice(None), slice(0, N)))
    B = _slice(tmp, (slice(None), slice(None), slice(N, M)))
    J_H = _gauss_solve_df(A, B)  # (F, N, M-N)
    # bottom rows [J, -I]: J = conj(J_H)^T
    J = df.cconj(tree_map(lambda a: jnp.swapaxes(a, 1, 2), J_H))
    negI = _ceye(F, M - N)
    negI = df.cneg(negI)
    bottom = _concat([J, negI], axis=2)  # (F, M-N, M)
    return _concat([W1, bottom], axis=1)


def init_w_hat_df(F, M, n_src, Cx=None, W0=None):
    """Identity target rows (or W0), [., -I] background, OC imposed once."""
    N = n_src
    W = _ceye(F, M)
    if N < M:
        parts = [_slice(W, (slice(None), slice(0, N), slice(None)))]
        negI = df.cneg(_ceye(F, M - N))
        zero = _czero((F, M - N, N))
        parts.append(_concat([zero, negI], axis=2))
        W = _concat(parts, axis=1)
    if W0 is not None:
        top = _slice(W0, (slice(None), slice(0, N), slice(None)))
        rest = _slice(W, (slice(None), slice(N, M), slice(None)))
        W = _concat([top, rest], axis=1) if N < M else top
    if N < M:
        W = _update_j_df(W, Cx, N)
    return W


def _epoch_df(xr, xi, W, Cx, n_src, model, chunk):
    T, F, M = xr.shape
    N = n_src
    W1 = _slice(W, (slice(None), slice(0, N), slice(None)))
    pw = _demix_pw(xr, xi, W1, chunk=max(chunk, 32))
    _, phi = _activations_df(pw, F, model)
    Vs = _wcov_all_df(xr, xi, phi, chunk=chunk)
    for k in range(N):
        V = Vs[k]
        WV = _cmatmul(W, V)
        ek = _czero((F, M, 1))
        ek = (
            (ek[0][0].at[:, k, 0].set(1.0), ek[0][1]),
            ek[1],
        )
        w = _gauss_solve_df(WV, ek)  # (F, M, 1)
        w = _slice(w, (slice(None), slice(None), 0))  # (F, M)
        den = _quad_form_re(w, V)  # (F,) df real
        good = den[0] > 0.0
        den = df.where(good, den, df.from_float(jnp.ones_like(den[0])))
        scale = df.recip(df.sqrt(den))
        w = df.cscale(w, tree_map(lambda x: x[:, None], scale))
        # keep the previous row on dead bins (same guard as the f32 path)
        prev_conj = df.cconj(_slice(W, (slice(None), k, slice(None))))
        w = df.cwhere(good[:, None], w, prev_conj)
        row = df.cconj(w)
        row = tree_map(lambda x: x[:, None, :], row)
        W = _concat(
            [
                _slice(W, (slice(None), slice(0, k), slice(None))),
                row,
                _slice(W, (slice(None), slice(k + 1, M), slice(None))),
            ],
            axis=1,
        )
        if N < M:
            W = _update_j_df(W, Cx, N)
    return W


@partial(jax.jit, static_argnames=("n_src", "model", "chunk"))
def overiva_df_iterations(xr, xi, W, Cx, one, n_src, n_iter, model,
                          chunk=16):
    """Run n_iter df epochs. xr/xi: exact f32 planes of the c64 input
    (T,F,M); W: df W_hat pytree; Cx: df covariance (unused when N == M);
    ``one``: the runtime 1.0 for the FMA guard (ops/df.py docstring).
    ``n_iter`` is a DYNAMIC fori_loop bound — the (large) df trace
    compiles once per shape, not once per iteration count."""
    with df.fma_guard(one):
        return lax.fori_loop(
            0,
            jnp.asarray(n_iter, jnp.int32),
            lambda _, w: _epoch_df(xr, xi, w, Cx, n_src, model, chunk),
            W,
            unroll=False,
        )


@partial(jax.jit, static_argnames=("n_src", "proj_back", "chunk"))
def finalize_df(xr, xi, W, one, n_src, proj_back, chunk=64):
    """Final demix + projection back, all in df; returns f32 planes of Y."""
    T, F, M = xr.shape
    N = n_src
    with df.fma_guard(one):
        W1 = _slice(W, (slice(None), slice(0, N), slice(None)))
        c, n, pad = _chunk_frames(T, chunk)
        xr_p = jnp.pad(xr, ((0, pad), (0, 0), (0, 0))) if pad else xr
        xi_p = jnp.pad(xi, ((0, pad), (0, 0), (0, 0))) if pad else xi
        xr_b = xr_p.reshape(n, c, F, M)
        xi_b = xi_p.reshape(n, c, F, M)

        def body(_, blk):
            br, bi = blk
            return None, _demix_block(br, bi, W1)

        _, Yb = lax.scan(body, None, (xr_b, xi_b))
        Y = tree_map(lambda a: a.reshape(n * c, F, N)[:T], Yb)
        if proj_back:
            # z = sum_t conj(x0) Y / sum_t |Y|^2  (oracle/projection.py)
            x0r = xr[:, :, 0:1]
            x0i = xi[:, :, 0:1]
            num = _sum_axis(df.cmul_pure(Y, x0r, -x0i), 0)  # (F, N)
            den = df.sum_tree(df.cabs2(Y), 0)  # (F, N) real df
            ok = den[0] > 0.0
            zre = df.where(ok, df.div(num[0], den),
                           df.from_float(jnp.ones_like(num[0][0])))
            zim = df.where(ok, df.div(num[1], den),
                           df.from_float(jnp.zeros_like(num[1][0])))
            # Y *= conj(z)
            zc = df.cconj((zre, zim))
            Y = df.cmul(Y, tree_map(lambda x: x[None, :, :], zc))
        return df.to_float(Y[0]), df.to_float(Y[1])


def planes_to_df(re, im):
    """Exact c64 planes -> df complex pytree."""
    return (df.from_float(re), df.from_float(im))


def df_to_planes(z):
    return df.to_float(z[0]), df.to_float(z[1])


@partial(jax.jit, static_argnames=("n_src", "has_w0"))
def prepare_df(xr, xi, w0r, w0i, one, n_src, has_w0):
    """Covariance (when overdetermined) + initial W_hat, all in df."""
    T, F, M = xr.shape
    with df.fma_guard(one):
        Cx = covariance_df(xr, xi) if n_src < M else _czero((F, M, M))
        W0 = planes_to_df(w0r, w0i) if has_w0 else None
        W = init_w_hat_df(F, M, n_src, Cx=Cx, W0=W0)
    return W, Cx
