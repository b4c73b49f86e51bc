"""Complex <-> float boundary packing.

The public jitted entry points take and return float arrays and split or
merge complex values on the host and inside jit: a boundary that the first
accelerator this system ran on required (it could not move complex arrays
between host and device). The GPU moves complex arrays directly; removing
the float-plane boundary is an open item (ROADMAP Queue 3).
"""

from __future__ import annotations

import numpy as np

__all__ = ["split_np", "merge_np", "merge_jnp", "split_jnp", "real_dtype_of"]


def split_np(x: np.ndarray, dtype=np.float32):
    """Host-side: complex ndarray -> (real, imag) float ndarrays."""
    x = np.asarray(x)
    return (
        np.ascontiguousarray(x.real, dtype=dtype),
        np.ascontiguousarray(x.imag, dtype=dtype),
    )


def merge_np(re: np.ndarray, im: np.ndarray) -> np.ndarray:
    """Host-side: (real, imag) -> complex ndarray."""
    re = np.asarray(re)
    im = np.asarray(im)
    out_dtype = np.complex64 if re.dtype == np.float32 else np.complex128
    return re.astype(out_dtype) + 1j * im.astype(out_dtype)


def merge_jnp(re, im):
    """Trace-side: (real, imag) float -> complex."""
    import jax.numpy as jnp

    return jnp.asarray(re) + 1j * jnp.asarray(im)


def split_jnp(x):
    """Trace-side: complex -> (real, imag) floats (for returning from jit)."""
    import jax.numpy as jnp

    x = jnp.asarray(x)
    return jnp.real(x), jnp.imag(x)


def real_dtype_of(complex_dtype):
    return np.float32 if np.dtype(complex_dtype) == np.complex64 else np.float64
