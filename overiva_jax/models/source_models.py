"""JAX source models (trace-side). Mirrors the oracle
(``overiva_jax/oracle/models.py``, SURVEY.md §2.3.1)."""

from __future__ import annotations

import jax.numpy as jnp

EPS = 1e-15
# Relative activation floor: r >= REL_EPS * max_t r per source. Bounds the
# weight dynamic range (phi = 1/r) so the weighted covariance stays
# invertible. Without it the time-varying gauss model collapses at M >> N
# (an output nulls a frame -> phi explodes -> WV singular -> NaN, in f64
# too — PARITY.md row 13). Matches the oracle exactly.
REL_EPS = 1e-3

__all__ = ["EPS", "REL_EPS", "activations", "MODELS"]

MODELS = ("laplace", "gauss")


def power(Y, bin_mask=None):
    """Per-frame per-source power sum_f |Y|^2. Y: (T, F, N) -> (T, N).

    When bins are sharded across chips this is the per-shard partial sum —
    psum it over the 'bins' mesh axis before :func:`activations_from_power`
    (the single collective in the hot loop, SURVEY.md §5.8). ``bin_mask``
    (F,) zeroes the contribution of replicate-padded bins on sharded runs.
    """
    p = jnp.abs(Y) ** 2
    if bin_mask is not None:
        p = p * bin_mask.astype(p.dtype)[None, :, None]
    return jnp.sum(p, axis=1)


def activations_from_power(pw, n_freq: int, model: str, eps: float = EPS):
    """r, phi = 1/r from the (globally-reduced) per-frame power (T, N)."""
    if model == "laplace":
        r = 2.0 * jnp.sqrt(pw)
    elif model == "gauss":
        r = pw / n_freq
    else:
        raise ValueError(f"unknown source model {model!r}")
    r = jnp.maximum(r, eps)
    r = jnp.maximum(r, REL_EPS * jnp.max(r, axis=0, keepdims=True))
    return r, 1.0 / r


def activations(Y, model: str, eps: float = EPS):
    """r, phi = 1/r from current estimates Y (T, F, N). ``model`` is static."""
    return activations_from_power(power(Y), Y.shape[1], model, eps)
