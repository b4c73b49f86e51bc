"""PCA + AuxIVA core (trace-side). Mirrors the oracle
(``overiva_jax/oracle/auxiva_pca.py``, SURVEY.md §2.3.5)."""

from __future__ import annotations

import jax.numpy as jnp

from ..ops.covariance import covariance
from ..ops.linalg import PRECISION, align_eigvec_phase, eigh
from .overiva import overiva_run

__all__ = ["pca", "auxiva_pca_run"]


def pca(X, n_src: int, return_basis: bool = False):
    """Per-bin projection onto the top-n_src principal subspace.

    X: (T, F, M) -> (T, F, n_src). Eigenvectors by descending eigenvalue, no
    whitening (matches the oracle's documented choice).
    """
    Cx = covariance(X)
    _, vecs = eigh(Cx)  # ascending
    E_top = vecs[:, :, ::-1][:, :, :n_src]  # (F, M, n_src)
    # deterministic phase (matches the oracle), aligning the XLA and
    # LAPACK bases — PARITY round-2 fix
    E_top = align_eigvec_phase(E_top)
    X_r = jnp.einsum("fmk,tfm->tfk", jnp.conj(E_top), X, precision=PRECISION)
    if return_basis:
        return X_r, E_top
    return X_r


def auxiva_pca_run(X, n_src: int, n_iter: int, model: str):
    """PCA reduce then determined AuxIVA. Returns (Y, W_reduced)."""
    M = X.shape[2]
    X_r = pca(X, n_src) if n_src < M else X
    return overiva_run(X_r, n_src, n_iter, model)
