"""Weighted and plain covariance construction — the hot-loop quantity.

V_k[f] = (1/T) sum_t phi[t,k] x[t,f] x[t,f]^H  (SURVEY.md §0, §3.2).

Formulated as an F-batched matrix product (contract over frames) so XLA
hands it to a batched GEMM and fuses the phi-weighting into the operand
load, without materializing a (T, F, M, M) intermediate. A frame-chunked lax.scan variant
bounds the (T, F, M) temporary for long recordings (SURVEY.md §5.7 — the
memory-scaling analog of blockwise attention).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from .linalg import PRECISION

WCOV_MODES = ("f32", "f32x3", "bf16")


def _wcov_precision(wcov: str):
    """f32 -> HIGHEST (full float32 products); f32x3 -> HIGH, which the
    GPU runs as TF32: ~1e-4 relative error on V at the headline shape,
    measured on an H100 (bench/exp_wcov_tiers.py). The name is kept from
    the first accelerator, where HIGH meant three bfloat16 passes."""
    if wcov == "f32x3":
        return lax.Precision.HIGH
    if wcov == "f32":
        return PRECISION
    raise ValueError(f"wcov must be one of {WCOV_MODES}, got {wcov!r}")

__all__ = [
    "covariance",
    "weighted_covariance",
    "weighted_covariance_all",
    "weighted_covariance_tf",
    "weighted_covariance_chunked",
]


def covariance(X):
    """Cx[f] = (1/T) sum_t x x^H. X: (T, F, M) -> (F, M, M)."""
    T = X.shape[0]
    return (
        jnp.einsum("tfm,tfn->fmn", X, jnp.conj(X), precision=PRECISION) / T
    )


def weighted_covariance(X, phi):
    """V[f] = (1/T) sum_t phi[t] x x^H. X: (T, F, M), phi: (T,) -> (F, M, M)."""
    T = X.shape[0]
    Xw = X * phi[:, None, None].astype(X.real.dtype)
    return (
        jnp.einsum("tfm,tfn->fmn", Xw, jnp.conj(X), precision=PRECISION) / T
    )


def weighted_covariance_all(X, phi, wcov: str = "f32", chunk=None):
    """All sources' weighted covariances in ONE pass over X.

    V[k, f] = (1/T) sum_t phi[t, k] x x^H. X: (T, F, M), phi: (T, K)
    -> (K, F, M, M). The per-source V_k depend only on the epoch-start
    weights, so they can be computed together up front. (Measured
    perf-neutral vs K separate calls at the benchmark shapes — XLA already
    pipelines the X reads — but it makes the independence explicit and
    keeps the source loop solve-only.)

    ``wcov="bf16"`` rounds the contraction operands to bfloat16 with
    float32 accumulation: ~1e-3 relative error on V; the IP iteration is a
    fixed-point map, so the final separation quality moves by well under
    0.1 dB at moderate reverb (tests/test_bf16.py). ``wcov="f32x3"`` keeps
    f32 operands and asks for ``lax.Precision.HIGH`` (TF32 on the GPU,
    ~1e-4 relative on V). What each tier saves on the H100:
    bench/exp_wcov_tiers.py.

    ``chunk``: scan the frame axis in blocks so the (K, chunk, F, M)
    weighted temporary is bounded by the chunk (long recordings).
    """
    T = X.shape[0]
    if chunk and chunk < T:
        K = phi.shape[1]
        F, M = X.shape[1], X.shape[2]
        if T % chunk != 0:
            pad = chunk - T % chunk
            X = jnp.concatenate([X, jnp.zeros((pad, F, M), X.dtype)], axis=0)
            phi = jnp.concatenate(
                [phi, jnp.zeros((pad, K), phi.dtype)], axis=0
            )
        n_chunks = X.shape[0] // chunk
        Xc = X.reshape(n_chunks, chunk, F, M)
        pc = phi.reshape(n_chunks, chunk, K)

        def body(acc, inputs):
            xb, pb = inputs
            acc = acc + weighted_covariance_all(xb, pb, wcov) * chunk
            return acc, None

        V, _ = lax.scan(
            body, jnp.zeros((K, F, M, M), X.dtype), (Xc, pc)
        )
        return V / T
    if wcov == "bf16":
        xr = X.real.astype(jnp.bfloat16)
        xi = X.imag.astype(jnp.bfloat16)
        w = phi.T[:, :, None, None].astype(jnp.bfloat16)  # (K,1->T,1,1)
        wr, wi = xr[None] * w, xi[None] * w

        def mm(a, b):
            return jnp.einsum(
                "ktfm,tfn->kfmn",
                a,
                b,
                precision=PRECISION,
                preferred_element_type=jnp.float32,
            )

        # (a + ib)(c - id) expanded in real planes, f32 accumulation
        Vre = mm(wr, xr) + mm(wi, xi)
        Vim = mm(wi, xr) - mm(wr, xi)
        return (Vre + 1j * Vim).astype(X.dtype) / T
    Xw = X[None] * phi.T[:, :, None, None].astype(X.real.dtype)  # (K,T,F,M)
    return (
        jnp.einsum(
            "ktfm,tfn->kfmn", Xw, jnp.conj(X),
            precision=_wcov_precision(wcov),
        )
        / T
    )


def weighted_covariance_tf(X, w_tf, wcov: str = "f32"):
    """Per-(t,f) weighted covariance (ILRMA / FastMNMF2 Q rows):
    V[f] = (1/T) sum_t w[t,f] x x^H. X: (T, F, M), w_tf: (T, F) -> (F, M, M).

    ``wcov="bf16"``: bfloat16 operands with f32 accumulation, same trade
    as :func:`weighted_covariance_all`.
    """
    T = X.shape[0]
    if wcov == "bf16":
        xr = X.real.astype(jnp.bfloat16)
        xi = X.imag.astype(jnp.bfloat16)
        w = w_tf[:, :, None].astype(jnp.bfloat16)
        wr, wi = xr * w, xi * w

        def mm(a, b):
            return jnp.einsum(
                "tfm,tfn->fmn",
                a,
                b,
                precision=PRECISION,
                preferred_element_type=jnp.float32,
            )

        Vre = mm(wr, xr) + mm(wi, xi)
        Vim = mm(wi, xr) - mm(wr, xi)
        return (Vre + 1j * Vim).astype(X.dtype) / T
    Xw = X * w_tf[:, :, None].astype(X.real.dtype)
    return (
        jnp.einsum(
            "tfm,tfn->fmn", Xw, jnp.conj(X), precision=_wcov_precision(wcov)
        )
        / T
    )


def weighted_covariance_chunked(X, phi, chunk: int = 256, wcov: str = "f32"):
    """Frame-chunked accumulation of the weighted covariance.

    Equivalent to :func:`weighted_covariance` but scans over T in blocks so
    the (chunk, F, M) weighted temporary is the only extra memory. T must be
    a multiple of ``chunk`` (pad with phi=0 frames otherwise).

    ``wcov="bf16"`` casts each chunk's operands to bfloat16 for the
    contraction (f32 accumulation across chunks), the streamed analog of
    :func:`weighted_covariance_all`'s fast mode.
    """
    T, F, M = X.shape
    if T % chunk != 0:
        pad = chunk - T % chunk
        X = jnp.concatenate([X, jnp.zeros((pad, F, M), X.dtype)], axis=0)
        phi = jnp.concatenate([phi, jnp.zeros((pad,), phi.dtype)], axis=0)
    n_chunks = X.shape[0] // chunk
    Xc = X.reshape(n_chunks, chunk, F, M)
    pc = phi.reshape(n_chunks, chunk)

    if wcov == "bf16":

        def body16(acc, inputs):
            xb, pb = inputs
            xr = xb.real.astype(jnp.bfloat16)
            xi = xb.imag.astype(jnp.bfloat16)
            w = pb[:, None, None].astype(jnp.bfloat16)
            wr, wi = xr * w, xi * w

            def mm(a, b):
                return jnp.einsum(
                    "tfm,tfn->fmn",
                    a,
                    b,
                    precision=PRECISION,
                    preferred_element_type=jnp.float32,
                )

            Vre = mm(wr, xr) + mm(wi, xi)
            Vim = mm(wi, xr) - mm(wr, xi)
            return acc + (Vre + 1j * Vim).astype(acc.dtype), None

        V, _ = lax.scan(body16, jnp.zeros((F, M, M), X.dtype), (Xc, pc))
        return V / T

    def body(acc, inputs):
        xb, pb = inputs
        xw = xb * pb[:, None, None].astype(xb.real.dtype)
        acc = acc + jnp.einsum(
            "tfm,tfn->fmn", xw, jnp.conj(xb), precision=_wcov_precision(wcov)
        )
        return acc, None

    V, _ = lax.scan(body, jnp.zeros((F, M, M), X.dtype), (Xc, pc))
    return V / T
