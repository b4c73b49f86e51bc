"""JAX projection back (trace-side). Same convention as the oracle
(``overiva_jax/oracle/projection.py``, SURVEY.md §2.3.6)."""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["projection_back", "apply_projection_back"]


def projection_back(Y, ref):
    """z[f,k] = sum_t conj(ref) Y / sum_t |Y|^2 (1 where the denom is 0)."""
    num = jnp.sum(jnp.conj(ref)[:, :, None] * Y, axis=0)
    denom = jnp.sum(jnp.abs(Y) ** 2, axis=0)
    return jnp.where(denom > 0.0, num / jnp.where(denom > 0.0, denom, 1.0), 1.0)


def apply_projection_back(Y, ref):
    z = projection_back(Y, ref)
    return Y * jnp.conj(z)[None, :, :]
