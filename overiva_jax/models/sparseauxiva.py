"""SparseAuxIVA reconstruction — fused JAX stage (trace-side).

JAX twin of ``overiva_jax.oracle.sparseauxiva`` (Jansky,
Koldovsky, Ono, IWAENC 2016 lineage; the oracle docstring carries the
design decisions and their A/B measurements). This module holds the
LASSO reconstruction stage; the IP-on-subset and polish stages reuse
``models.overiva`` on the sliced / full tensors (api.sparseauxiva wires
the phases together).

Device mapping: the FISTA iteration is two GEMMs per step — g @ E (the
partial DFT of all N*(M-1) filters at the selected bins at once) and the
adjoint against conj(E) — plus elementwise soft thresholding, all inside
one ``lax.fori_loop``. E is (support, k): a few hundred squared — a
real matrix product. The filter support is two CONTIGUOUS tap ranges (causal head,
acausal tail), so scattering the solution into the full nfft circle is a
static concatenate, not a scatter (DESIGN.md §2b rules).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.linalg import PRECISION, small_inv

__all__ = ["sparse_reconstruct", "sparse_rtfs", "sparse_rtf_taps"]


def sparse_rtfs(Ws):
    """Mixing-side RTFs at the measured bins (unit response at mic 0).

    Ws: (k, M, M) demixing -> R_s (k, M, M), columns = normalized steering.
    """
    A_s = small_inv(Ws)
    return A_s / A_s[:, :1, :]


def sparse_rtf_taps(
    R_s, S, nfft: int, n_causal: int, n_acausal: int, lasso_iter: int,
    lam_ratio, pvary_axes=None,
):
    """FISTA LASSO for the support-restricted RTF impulse responses.

    R_s: (k, M, M) RTFs at bins ``S`` (k,) int. Returns the full-circle tap
    tensor g_full (M*(M-1), nfft) real — rfft of it gives every filter's
    full-band RTF. Shared by the single-device :func:`sparse_reconstruct`
    and the bin-sharded path (``parallel.sharded.sharded_sparseauxiva``),
    where it runs replicated per shard after a k-bin gather of Ws.
    """
    k, M, _ = R_s.shape
    cdtype = R_s.dtype
    rdtype = jnp.finfo(cdtype).dtype

    # DFT phase indices exactly, in integers mod nfft: the f32 product
    # support*S exceeds 2^24 once nfft >= 8192 and the phases go inexact.
    # Byte-split keeps every intermediate < 2^25 for any practical nfft.
    support = jnp.concatenate(
        [jnp.arange(n_causal), jnp.arange(nfft - n_acausal, nfft)]
    ).astype(jnp.int32)
    S_i = jnp.asarray(S, jnp.int32) % nfft
    lo, hi = S_i & 0xFF, S_i >> 8
    prod = (
        (support[:, None] * hi[None, :]) % nfft * 256
        + support[:, None] * lo[None, :]
    ) % nfft
    ang = (-2.0 * jnp.pi / nfft) * prod.astype(rdtype)
    E = jax.lax.complex(jnp.cos(ang), jnp.sin(ang)).astype(cdtype)  # (P, k)
    Eh = jnp.conj(E).T

    B = jnp.transpose(R_s[:, 1:, :], (2, 1, 0)).reshape(M * (M - 1), k)

    def AH(r):
        return jnp.real(jnp.matmul(r, Eh, precision=PRECISION))

    lam = lam_ratio * jnp.max(jnp.abs(AH(B)), axis=-1, keepdims=True)
    step = 1.0 / nfft  # rows of the full-circle partial DFT are orthogonal

    def fista_step(_, state):
        g, v, t = state
        r = jnp.matmul(v.astype(cdtype), E, precision=PRECISION) - B
        u = v - step * AH(r)
        g_new = jnp.sign(u) * jnp.maximum(jnp.abs(u) - step * lam, 0.0)
        t_new = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
        v_new = g_new + ((t - 1.0) / t_new) * (g_new - g)
        return g_new, v_new, t_new

    g0 = jnp.zeros((M * (M - 1), n_causal + n_acausal), rdtype)
    t0 = jnp.asarray(1.0, rdtype)
    if pvary_axes:
        # under shard_map the constant-initialized carry must already have
        # the varying-axes type its (data-dependent) loop outputs will have
        g0 = lax.pcast(g0, tuple(pvary_axes), to="varying")
        t0 = lax.pcast(t0, tuple(pvary_axes), to="varying")
    g, _, _ = lax.fori_loop(0, lasso_iter, fista_step, (g0, g0, t0))

    # static concatenate into the full circle (support ranges contiguous)
    mid = jnp.zeros((M * (M - 1), nfft - n_causal - n_acausal), rdtype)
    return jnp.concatenate([g[:, :n_causal], mid, g[:, n_causal:]], axis=1)


@partial(
    jax.jit,
    static_argnames=("F", "nfft", "n_causal", "n_acausal", "lasso_iter"),
)
def sparse_reconstruct(
    Ws, S, F: int, nfft: int, n_causal: int, n_acausal: int,
    lasso_iter: int, lam_ratio,
):
    """Full-band demixing from IP results on the selected bins.

    Ws: (k, M, M) complex demixing at bins ``S`` (k,) int. Returns W
    (F, M, M): inv of the RTF-normalized mixing, measured bins verbatim.
    """
    k, M, _ = Ws.shape
    cdtype = Ws.dtype
    R_s = sparse_rtfs(Ws)
    g_full = sparse_rtf_taps(
        R_s, S, nfft, n_causal, n_acausal, lasso_iter, lam_ratio
    )
    R_rec = jnp.fft.rfft(g_full, axis=-1).astype(cdtype)  # (M(M-1), F)
    A_rec = jnp.concatenate(
        [
            jnp.ones((F, 1, M), cdtype),
            jnp.transpose(R_rec.reshape(M, M - 1, F), (2, 1, 0)),
        ],
        axis=1,
    )
    A_rec = A_rec.at[S].set(R_s)  # one-time scatter, not in a hot loop
    return small_inv(A_rec)
