"""WPE dereverberation as one fused XLA program (F-batched).

JAX twin of ``overiva_jax.oracle.wpe`` (same update equations — iterative
variance-normalized delayed linear prediction, Nakatani et al. 2010). Design
notes:

- The tap stack is built by ``taps`` static zero-pads + slices (no gather:
  the shift amounts are static, so XLA lowers each to one pad/slice pair
  and fuses the stack).
- Both weighted statistics contract the frame axis as one
  einsum each — R is (F, MK, MK), P is (F, MK, M), exactly the wcov
  pattern from ``ops/covariance.py`` at a larger row dimension
  (MK = M*taps is 16-80: much larger products than the M=8 wcov).
- The MK x MK solve uses :func:`ops.linalg.gauss_solve` — the mask-pivoted
  Gauss-Jordan already replaces XLA's pathologically slow batched tiny-LU
  for the IVA hot loop (docs/DESIGN.md §2); at MK ~ 16-80 it is still the
  right tool (one fused elementwise pass per pivot over the (F, MK, MK+M)
  tableau). R is Hermitian PD after the trace-relative diagonal load, so
  partial pivoting is comfortably stable.
- ``n_iter`` is a static Python unroll (2-3 in practice: the lam/filter
  alternation converges in very few sweeps).

The activation floor is relative (``_EPS * mean(lam)``), matching the
framework-wide convention (PARITY.md row 13) so pure-f32 runs cannot
underflow the weights to inf.
"""

from __future__ import annotations

import jax.numpy as jnp

from .linalg import PRECISION, gauss_solve

__all__ = ["wpe", "delayed_taps"]

_EPS = 1e-10


def delayed_taps(X, taps: int, delay: int):
    """Stack delayed frames: (T, F, M) -> (T, F, M*taps).

    Xd[t, f, m*taps + k] = X[t - delay - k, f, m], zero-padded at t < 0.
    Static unroll over k: each tap is one pad+slice, fused by XLA.
    """
    T, F, M = X.shape
    cols = []
    for k in range(taps):
        s = delay + k
        if s < T:
            shifted = jnp.pad(X, ((s, 0), (0, 0), (0, 0)))[:T]
        else:
            shifted = jnp.zeros_like(X)
        cols.append(shifted)
    # (taps, T, F, M) -> (T, F, M, taps) -> (T, F, M*taps); matches the
    # oracle's memory order (channel-major, tap-minor).
    Xd = jnp.stack(cols, axis=-1)
    return Xd.reshape(T, F, M * taps)


def wpe(X, taps: int = 10, delay: int = 3, n_iter: int = 3,
        diag_load: float = 1e-5):
    """Dereverberate a multichannel STFT: (T, F, M) complex -> (T, F, M)."""
    T, F, M = X.shape
    Xd = delayed_taps(X, taps, delay)  # (T, F, MK)
    MK = M * taps
    eye = jnp.eye(MK, dtype=X.dtype)
    rdt = X.real.dtype
    Y = X
    for _ in range(n_iter):
        lam = jnp.mean(jnp.abs(Y) ** 2, axis=2)  # (T, F) real
        lam = jnp.maximum(lam, _EPS * jnp.maximum(jnp.mean(lam), 1e-30))
        Xw = Xd / lam[:, :, None].astype(rdt)
        R = jnp.einsum("tfa,tfb->fab", Xw, jnp.conj(Xd), precision=PRECISION)
        P = jnp.einsum("tfa,tfm->fam", Xw, jnp.conj(X), precision=PRECISION)
        tr = jnp.real(jnp.trace(R, axis1=1, axis2=2)) / MK  # (F,)
        load = diag_load * jnp.maximum(tr, 1e-30)
        R = R + load[:, None, None].astype(rdt) * eye
        G = gauss_solve(R, P)  # (F, MK, M)
        Y = X - jnp.einsum("fam,tfa->tfm", jnp.conj(G), Xd,
                           precision=PRECISION)
    return Y
