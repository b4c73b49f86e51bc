"""Online (streaming) AuxIVA-ISS core — block-wise updates (trace-side).

Streaming capability extension in the spirit of the retrieved paper list
(PAPERS.md: arXiv:2209.00937, "Inverse-free online IVA with flexible
iterative source steering"): STFT frames arrive in fixed-size blocks; the
demixing matrix is refined by one rank-1 source-steering pass per block
using exponentially-forgotten statistics, so the separator tracks the
mixture over time with O(block) latency and no matrix solves.

State per stream (all device-resident):
  W        (F, M, M)   demixing matrix
  num      (M, F, M)   EW sums  E_w[phi_m y_m conj(y_n)]  (indexed by n)
  den      (M, F, M)   EW sums  E_w[phi_m |y_n|^2]
  zn, zd   (F, M)      EW projection-back statistics vs mic 0
  t_eff    ()          effective frame count (for the self-scaling term)
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..ops.linalg import PRECISION
from .overiva import demix
from .source_models import activations_from_power, power

__all__ = ["online_iss_init", "online_iss_step"]

_EPS = 1e-15


@partial(jax.jit, static_argnames=("F", "M", "dtype"))
def online_iss_init(F: int, M: int, dtype=jnp.complex64):
    # jitted: the complex state is created on the device
    rdtype = jnp.float32 if dtype == jnp.complex64 else jnp.float64
    eye = jnp.eye(M, dtype=rdtype).astype(dtype)
    return {
        "W": jnp.tile(eye, (F, 1, 1)),
        "num": jnp.zeros((M, F, M), dtype),
        "den": jnp.zeros((M, F, M), rdtype),
        "zn": jnp.zeros((F, M), dtype),
        "zd": jnp.zeros((F, M), rdtype),
        "t_eff": jnp.zeros((), rdtype),
    }


@partial(jax.jit, static_argnames=("model", "n_pass", "ramp", "axis_name",
                                   "n_freq"))
def online_iss_step(
    X_blk, state, forget, model: str = "laplace", n_pass: int = 1,
    ramp: bool = False, pb_forget=None, axis_name=None, n_freq=None,
    bin_mask=None,
):
    """Process one STFT block. X_blk: (B, F, M) complex.

    Returns (Y_blk projection-back scaled, new state).

    ``ramp``: forgetting-factor scheduling (the classic RLS warm-up): the
    first blocks run a growing uniform window (lam -> 1, every frame kept)
    and lam decays linearly to ``forget`` as the seen-frame count reaches
    the forget factor's effective memory 1/(1-forget). MEASURED NEGATIVE
    on stationary scenes (round 3 A/B, forget 0.92 and 0.985): early
    purity unchanged (the zero-initialized unnormalized EW sums already
    act as a growing window — nothing exists to discount), late purity
    slightly LOWER (the ramp keeps stale early statistics weighted through
    the transition). Kept as an option for tracking scenarios; default off.

    ``pb_forget``: separate (typically longer) forgetting factor for the
    block-wise projection-back statistics zn/zd — smooths the per-block
    output scale without slowing demixing adaptation. Measured mildly
    positive at 0.9995 on the stationary regression scene (late purity
    23.7 -> 27.3).
    """
    B, F, M = X_blk.shape
    lam = forget.astype(state["den"].dtype)
    if ramp:
        frac = jnp.clip(1.0 - state["t_eff"] * (1.0 - lam), 0.0, 1.0)
        lam = lam + (1.0 - lam) * frac
    pb_lam = lam if pb_forget is None else pb_forget.astype(lam.dtype)
    W, num, den = state["W"], state["num"], state["den"]
    t_eff = state["t_eff"] * lam + B

    for _ in range(n_pass):
        Y = demix(X_blk, W)
        # bin-sharded execution (parallel/sharded.py): the frame power is
        # the ONE cross-bin quantity per pass — a (B, M) real psum, same
        # collective budget as the batch _iss_epoch
        pw = power(Y, bin_mask)
        if axis_name is not None:
            pw = jax.lax.psum(pw, axis_name)
        _, phi = activations_from_power(pw, n_freq or F, model)  # (B, M)
        phif = phi.astype(Y.real.dtype)
        for n in range(M):
            yn = Y[:, :, n]
            blk_num = jnp.einsum(
                "tm,tfm,tf->fm", phif, Y, jnp.conj(yn), precision=PRECISION
            )
            blk_den = jnp.real(
                jnp.einsum("tm,tf,tf->fm", phif, yn, jnp.conj(yn), precision=PRECISION)
            )
            num = num.at[n].set(lam.astype(num.dtype) * num[n] + blk_num)
            den = den.at[n].set(lam * den[n] + blk_den)

            v = num[n] / jnp.maximum(den[n], _EPS).astype(num.dtype)
            dnn = den[n][:, n] / jnp.maximum(t_eff, 1.0)
            vnn = 1.0 - jax.lax.rsqrt(jnp.maximum(dnn, _EPS))
            col = jnp.arange(M)[None, :] == n
            v = jnp.where(col, vnn.astype(v.dtype)[:, None], v)
            W = W - v[:, :, None] * W[:, n, :][:, None, :]

    # output + streaming projection back vs mic 0
    Y = demix(X_blk, W)
    zn = state["zn"] * pb_lam.astype(state["zn"].dtype) + jnp.sum(
        jnp.conj(X_blk[:, :, 0])[:, :, None] * Y, axis=0
    )
    zd = state["zd"] * pb_lam + jnp.sum(jnp.abs(Y) ** 2, axis=0)
    z = jnp.where(zd > 0.0, zn / jnp.where(zd > 0.0, zd, 1.0).astype(zn.dtype), 1.0)
    Y_out = Y * jnp.conj(z)[None, :, :]

    new_state = {"W": W, "num": num, "den": den, "zn": zn, "zd": zd, "t_eff": t_eff}
    return Y_out, new_state
