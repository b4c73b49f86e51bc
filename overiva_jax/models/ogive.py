"""OGIVE core — JAX ``lax.while_loop`` with in-graph early exit (trace-side).

Accelerator re-design of the reference's ``ive.py`` (SURVEY.md §2.3.4, §3.3):
thousands of cheap, fully bin-vectorized gradient steps run inside ONE XLA
while loop whose convergence predicate (max relative step < tol) is evaluated
on-device — no host sync per iteration. Update math mirrors the NumPy oracle
(``overiva_jax/oracle/ogive.py``) exactly, including the orthogonal-constraint
couplings and the reconstructed switching criterion.

The loop body runs bin-minor (docs/DESIGN.md §2b): carrying (M, F) with
bins as the contiguous axis makes every gradient step a handful of long
unit-stride elementwise passes. The public state shapes at the jit
boundary stay F-major (F, M).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.covariance import covariance
from ..ops.fminor import matvec_fm, to_fminor
from ..ops.linalg import PRECISION, align_eigvec_phase, eigh, small_inv
from .source_models import activations_from_power, power

__all__ = ["ogive_init", "ogive_iterations", "ogive_demix"]


def _oc_a_from_w(wp, Cxp):
    """Mixing vector from demixing vector, bin-minor: (M,F), (M,M,F)."""
    v = matvec_fm(Cxp, wp)
    lam = jnp.real(jnp.sum(jnp.conj(wp) * v, axis=0))
    return v / lam.astype(v.real.dtype)[None, :]


def _oc_w_from_a(ap, Cx_invp):
    v = matvec_fm(Cx_invp, ap)
    lam = jnp.real(jnp.sum(jnp.conj(ap) * v, axis=0))
    return v / lam.astype(v.real.dtype)[None, :]


def _switch_mask(ap, Cxp, Cx_invp):
    """use-mix mask: target-dominant bins (MPDR power > mean channel power)."""
    M = Cxp.shape[0]
    sigma_s2 = 1.0 / jnp.real(
        jnp.sum(jnp.conj(ap)[:, None, :] * Cx_invp * ap[None, :, :], axis=(0, 1))
    )
    mean_pow = jnp.real(sum(Cxp[m, m] for m in range(M))) / M
    return sigma_s2 > mean_pow


def ogive_init(X, init_eig: bool):
    """Initial (w, a, Cx, Cx_inv). w: (F, M) demixing vectors."""
    T, F, M = X.shape
    Cx = covariance(X)
    Cx_inv = small_inv(Cx)
    if init_eig:
        _, vecs = eigh(Cx)
        top = align_eigvec_phase(vecs[:, :, -1:])  # deterministic phase
        w = jnp.conj(top[:, :, 0])  # principal component, demix convention
    else:
        w = jnp.zeros((F, M), X.dtype).at[:, 0].set(1.0)
    a = _oc_a_from_w(w.T, to_fminor(Cx)).T
    return w, a, Cx, Cx_inv


def ogive_demix(X, w):
    """y[t,f] = w[f]^H x[t,f]."""
    return jnp.einsum("fm,tfm->tf", jnp.conj(w), X, precision=PRECISION)


@partial(
    jax.jit,
    static_argnames=(
        "n_iter", "model", "update", "switch_every", "axis_name", "n_freq",
        "done_pvary_axes",
    ),
)
def ogive_iterations(
    X,
    w,
    a,
    use_mix,
    Cx,
    Cx_inv,
    epoch0,
    step_size,
    tol,
    n_iter: int,
    model: str,
    update: str,
    switch_every: int = 10,
    axis_name=None,
    n_freq=None,
    bin_mask=None,
    done_pvary_axes: tuple = (),
):
    """Run up to ``n_iter`` more epochs (counting from ``epoch0``), stopping
    early when ``step_size * max_f ||step||/||w|| < tol``.

    Returns (w, a, use_mix, epoch, done). Chunk-resumable for callbacks: pass
    the returned state back in with a larger n_iter budget.

    ``axis_name``/``n_freq``/``bin_mask``: bin-sharded execution — the
    per-frame power is psum'd and the convergence max is pmax'd over the
    mesh axis; padded bins are masked out of both (SURVEY.md §2.4).
    """
    T, F, M = X.shape
    limit = epoch0 + n_iter

    # loop-invariant bin-minor copies (transposed once, outside the loop)
    Xp = jnp.transpose(X, (2, 0, 1))  # (M, T, F)
    Cxp = to_fminor(Cx)
    Cx_invp = to_fminor(Cx_inv)

    def cond(state):
        _, _, _, epoch, done = state
        return jnp.logical_and(jnp.logical_not(done), epoch < limit)

    def body(state):
        wp, ap, use_mix, epoch, done_in = state  # wp, ap: (M, F)

        if update == "switching":
            use_mix = lax.cond(
                epoch % switch_every == 0,
                lambda: _switch_mask(ap, Cxp, Cx_invp),
                lambda: use_mix,
            )

        y = sum(jnp.conj(wp)[m][None, :] * Xp[m] for m in range(M))  # (T, F)
        pw = power(y[:, :, None], bin_mask)  # (T, 1) — partial when sharded
        if axis_name is not None:
            pw = lax.psum(pw, axis_name)
        _, phi = activations_from_power(pw, n_freq or F, model)  # (T, 1)
        wy = phi[:, 0].astype(y.real.dtype)[:, None] * jnp.conj(y)
        xi = jnp.sum(wy[None, :, :] * Xp, axis=1) / T  # (M, F)
        nu = jnp.maximum(jnp.real(jnp.sum(wy * y, axis=0)) / T, 1e-30)
        resid = ap - xi / nu.astype(xi.real.dtype)[None, :]

        def norm0(v):
            return jnp.sqrt(jnp.sum(jnp.abs(v) ** 2, axis=0))

        mu = step_size.astype(resid.real.dtype)
        if update == "demix":
            w_new = wp + mu * resid
            a_new = _oc_a_from_w(w_new, Cxp)
            step_norm = norm0(resid)
        elif update == "mix":
            delta_a = matvec_fm(Cx_invp, resid)
            a_new = ap + mu * delta_a
            w_new = _oc_w_from_a(a_new, Cx_invp)
            step_norm = norm0(delta_a)
        else:  # switching
            delta_a = matvec_fm(Cx_invp, resid)
            w_d = wp + mu * resid
            a_d = _oc_a_from_w(w_d, Cxp)
            a_m = ap + mu * delta_a
            w_m = _oc_w_from_a(a_m, Cx_invp)
            w_new = jnp.where(use_mix[None, :], w_m, w_d)
            a_new = jnp.where(use_mix[None, :], a_m, a_d)
            step_norm = jnp.where(use_mix, norm0(delta_a), norm0(resid))

        rel_f = step_norm / jnp.maximum(norm0(w_new), 1e-30)
        if bin_mask is not None:
            rel_f = rel_f * bin_mask.astype(rel_f.dtype)
        rel = jnp.max(rel_f)
        if axis_name is not None:
            rel = lax.pmax(rel, axis_name)
        done = jnp.logical_or(done_in, mu.real * rel < tol)

        # vmap safety: the single-mixture while_loop never re-enters the body
        # once done, but under vmap the loop runs until ALL batch elements
        # converge and the body keeps executing — freeze finished elements so
        # their trajectories (and epoch counts) match the unbatched path.
        w_new = jnp.where(done_in, wp, w_new)
        a_new = jnp.where(done_in, ap, a_new)
        epoch = jnp.where(done_in, epoch, epoch + 1)
        return (w_new, a_new, use_mix, epoch, done)

    done0 = jnp.asarray(False)
    if done_pvary_axes:
        # under shard_map the loop-exit flag is collective-computed (pmax over
        # the bins axis) and therefore varies over the remaining mesh axes;
        # the initial carry must carry the same varying-axes type. The epoch
        # counter is frozen through `done` in the body, so it varies too.
        done0 = lax.pcast(done0, done_pvary_axes, to="varying")
        epoch0 = lax.pcast(jnp.asarray(epoch0), done_pvary_axes, to="varying")
    state = (w.T, a.T, use_mix, epoch0, done0)
    wp, ap, use_mix, epoch, done = lax.while_loop(cond, body, state)
    return wp.T, ap.T, use_mix, epoch, done
