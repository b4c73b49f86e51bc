"""Sharded multi-chip separation via shard_map over a ('mix','bins') mesh.

Accelerator equivalent of the reference's only parallelism — the
``multiprocessing`` pool in ``mbss_sim.py`` — plus a bin-sharded axis the
reference has no analog for (SURVEY.md §2.4):

- ``mix``  axis: independent mixtures, zero collectives (data parallel).
- ``bins`` axis: frequency bins are independent given the activations, so
  each iteration needs exactly ONE collective — a (T, N) real psum of the
  per-shard signal power over ICI. Everything else (covariances, solves,
  OC updates, projection back) is per-bin local.

F is rarely divisible by the shard count (nfft/2+1 is odd), so bins are
replicate-padded and a mask zeroes the padding's power contribution; padded
outputs are sliced off on the way out.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from ..models import auxiva_iss as _iss
from ..models import fastmnmf2 as _fmnmf
from ..models import five as _five
from ..models import ilrma as _ilrma
from ..models import ilrma_t as _ilrma_t
from ..models import ogive as _ogive
from ..models import auxiva_pca as _pca_mod
from ..models import overiva as _core
from ..models import overiva_ip2 as _ip2
from ..models import sparseauxiva as _sparse
from ..models import tip as _tip
from ..models import tiss as _tiss
from ..ops import projection as _proj
from ..ops import wpe as _wpe
from ..ops.covariance import covariance
from ..ops.linalg import small_inv
from .mesh import AXIS_BINS, AXIS_MIX

__all__ = [
    "pad_bins",
    "sharded_overiva",
    "sharded_auxiva_pca",
    "sharded_ogive",
    "sharded_auxiva_iss",
    "sharded_ilrma",
    "sharded_overiva_iss",
    "sharded_overiva_ip2",
    "sharded_fastmnmf2",
    "sharded_five",
    "sharded_ilrma_t",
    "sharded_sparseauxiva",
    "sharded_tip",
    "sharded_tiss",
    "sharded_wpe",
    "sharded_online_iss",
    "sharded_online_tiss",
]


def pad_bins(F: int, n_shards: int):
    """(padded F, per-bin validity mask of length padded F)."""
    F_pad = -(-F // n_shards) * n_shards
    mask = np.zeros(F_pad, np.float32)
    mask[:F] = 1.0
    return F_pad, mask


def _separate_one(X, bin_mask, n_src, n_iter, model, n_freq_total, proj_back):
    """Per-shard, per-mixture OverIVA on the local bin slice.

    X: (T, F_local, M). Padded bins carry replicated data (well-conditioned
    solves) but contribute zero power via ``bin_mask``.
    """
    T, Fl, M = X.shape
    Cx = covariance(X)
    W_hat = _core.init_w_hat(X, n_src, init_eig=False, Cx=Cx)

    def epoch(_, W):
        return _core._epoch(
            X, W, Cx, n_src, model,
            axis_name=AXIS_BINS, n_freq=n_freq_total, bin_mask=bin_mask,
        )

    W_hat = jax.lax.fori_loop(0, n_iter, epoch, W_hat)
    Y = _core.demix(X, W_hat[:, :n_src, :])
    if proj_back:
        # per-(f,k) rescale: bin-local, no collective needed
        Y = _proj.apply_projection_back(Y, X[:, :, 0])
    return Y


@partial(
    jax.jit,
    static_argnames=("mesh", "n_src", "n_iter", "model", "proj_back", "n_freq_total"),
)
def _sharded_overiva_padded(
    X, bin_mask, mesh, n_src, n_iter, model, proj_back, n_freq_total
):
    """X: (B, T, F_pad, M) complex, bin_mask: (F_pad,) — both padded/divisible."""

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(AXIS_MIX, None, AXIS_BINS, None), P(AXIS_BINS)),
        out_specs=P(AXIS_MIX, None, AXIS_BINS, None),
    )
    def run(Xl, maskl):
        sep = lambda x: _separate_one(
            x, maskl, n_src, n_iter, model, n_freq_total, proj_back
        )
        return jax.vmap(sep)(Xl)

    return run(X, bin_mask)


def _iss_one(X, bin_mask, n_iter, model, n_freq_total, proj_back, n_src=None):
    """Per-shard, per-mixture AuxIVA-ISS / OverIVA-ISS on the local bin slice."""
    T, Fl, M = X.shape
    W = jnp.tile(jnp.eye(M, dtype=X.dtype), (Fl, 1, 1))
    # constant init must carry the same varying-axes type as the loop body
    W = jax.lax.pcast(W, (AXIS_MIX, AXIS_BINS), to="varying")
    Y = _core.demix(X, W)

    def epoch(_, s):
        return _iss._iss_epoch(
            X, s, model, axis_name=AXIS_BINS, n_freq=n_freq_total,
            bin_mask=bin_mask, n_src=n_src,
        )

    W, Y = jax.lax.fori_loop(0, n_iter, epoch, (W, Y))
    if n_src is not None:
        Y = Y[:, :, :n_src]
    if proj_back:
        Y = _proj.apply_projection_back(Y, X[:, :, 0])
    return Y


@partial(
    jax.jit,
    static_argnames=(
        "mesh", "n_iter", "model", "proj_back", "n_freq_total", "n_src"
    ),
)
def _sharded_iss_padded(
    X, bin_mask, mesh, n_iter, model, proj_back, n_freq_total, n_src=None
):
    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(AXIS_MIX, None, AXIS_BINS, None), P(AXIS_BINS)),
        out_specs=P(AXIS_MIX, None, AXIS_BINS, None),
    )
    def run(Xl, maskl):
        sep = lambda x: _iss_one(
            x, maskl, n_iter, model, n_freq_total, proj_back, n_src
        )
        return jax.vmap(sep)(Xl)

    return run(X, bin_mask)


def sharded_auxiva_iss(
    mesh,
    X_batch,
    n_iter: int = 20,
    model: str = "laplace",
    proj_back: bool = True,
    n_src: int | None = None,
):
    """AuxIVA-ISS (or OverIVA-ISS when ``n_src < M``) over the mesh.

    X_batch: (B, T, F, M) complex; returns (B, T, F, n_src or M)."""
    B, T, F, M = X_batch.shape
    n_mix = mesh.shape[AXIS_MIX]
    n_bins = mesh.shape[AXIS_BINS]
    if B % n_mix != 0:
        raise ValueError(f"batch {B} not divisible by mix axis {n_mix}")
    F_pad, mask = pad_bins(F, n_bins)
    if F_pad != F:
        reps = jnp.repeat(X_batch[:, :, -1:, :], F_pad - F, axis=2)
        X_batch = jnp.concatenate([X_batch, reps], axis=2)
    Y = _sharded_iss_padded(
        X_batch, jnp.asarray(mask), mesh, int(n_iter), model, bool(proj_back),
        int(F), None if n_src is None else int(n_src),
    )
    return Y[:, :, :F, :]


def sharded_overiva_iss(
    mesh, X_batch, n_src: int, n_iter: int = 20,
    model: str = "laplace", proj_back: bool = True,
):
    """OverIVA-ISS over the mesh (see ``models/auxiva_iss._iss_epoch``)."""
    return sharded_auxiva_iss(
        mesh, X_batch, n_iter=n_iter, model=model, proj_back=proj_back,
        n_src=n_src,
    )


def _tiss_one(
    X, bin_mask, taps, delay, n_iter, model, n_freq_total, proj_back,
    n_src=None,
):
    """Per-shard, per-mixture T-ISS on the local bin slice. The delayed-tap
    augmentation is a frame-axis shift, so it is fully bin-local — T-ISS
    keeps the family's single-psum comm pattern (the per-frame power)."""
    T, Fl, M = X.shape
    Xt = _tiss.augment_taps(X, taps, delay)
    Pm = _tiss.augmented_eye(Xt, M)
    # constant init must carry the same varying-axes type as the loop body
    Pm = jax.lax.pcast(Pm, (AXIS_MIX, AXIS_BINS), to="varying")
    Y = _core.demix(Xt, Pm)

    def epoch(_, s):
        return _tiss._tiss_epoch(
            Xt, s, model, M, axis_name=AXIS_BINS, n_freq=n_freq_total,
            bin_mask=bin_mask, n_src=n_src,
        )

    Pm, Y = jax.lax.fori_loop(0, n_iter, epoch, (Pm, Y))
    if n_src is not None:
        Y = Y[:, :, :n_src]
    if proj_back:
        Y = _proj.apply_projection_back(Y, X[:, :, 0])
    return Y


@partial(
    jax.jit,
    static_argnames=(
        "mesh", "taps", "delay", "n_iter", "model", "proj_back",
        "n_freq_total", "n_src",
    ),
)
def _sharded_tiss_padded(
    X, bin_mask, mesh, taps, delay, n_iter, model, proj_back, n_freq_total,
    n_src=None,
):
    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(AXIS_MIX, None, AXIS_BINS, None), P(AXIS_BINS)),
        out_specs=P(AXIS_MIX, None, AXIS_BINS, None),
    )
    def run(Xl, maskl):
        sep = lambda x: _tiss_one(
            x, maskl, taps, delay, n_iter, model, n_freq_total, proj_back,
            n_src,
        )
        return jax.vmap(sep)(Xl)

    return run(X, bin_mask)


def sharded_tiss(
    mesh,
    X_batch,
    n_src: int | None = None,
    taps: int = 5,
    delay: int = 2,
    n_iter: int = 20,
    model: str = "laplace",
    proj_back: bool = True,
):
    """T-ISS (joint dereverberation + separation) over the mesh.

    X_batch: (B, T, F, M) complex; returns (B, T, F, n_src or M)."""
    B, T, F, M = X_batch.shape
    n_mix = mesh.shape[AXIS_MIX]
    n_bins = mesh.shape[AXIS_BINS]
    if B % n_mix != 0:
        raise ValueError(f"batch {B} not divisible by mix axis {n_mix}")
    F_pad, mask = pad_bins(F, n_bins)
    if F_pad != F:
        reps = jnp.repeat(X_batch[:, :, -1:, :], F_pad - F, axis=2)
        X_batch = jnp.concatenate([X_batch, reps], axis=2)
    Y = _sharded_tiss_padded(
        X_batch, jnp.asarray(mask), mesh, int(taps), int(delay), int(n_iter),
        model, bool(proj_back), int(F),
        None if n_src is None else int(n_src),
    )
    return Y[:, :, :F, :]


def _ip2_one(X, bin_mask, n_src, n_iter, model, n_freq_total, proj_back):
    """Per-shard, per-mixture OverIVA-IP2 on the local bin slice (same
    single-psum comm pattern: the per-frame power reduction)."""
    T, Fl, M = X.shape
    Cx = covariance(X)
    W_hat = _core.init_w_hat(X, n_src, init_eig=False, Cx=Cx)

    def epoch(_, W):
        return _ip2._ip2_epoch(
            X, W, Cx, n_src, model,
            axis_name=AXIS_BINS, n_freq=n_freq_total, bin_mask=bin_mask,
        )

    W_hat = jax.lax.fori_loop(0, n_iter, epoch, W_hat)
    Y = _core.demix(X, W_hat[:, :n_src, :])
    if proj_back:
        Y = _proj.apply_projection_back(Y, X[:, :, 0])
    return Y


@partial(
    jax.jit,
    static_argnames=(
        "mesh", "n_src", "n_iter", "model", "proj_back", "n_freq_total"
    ),
)
def _sharded_ip2_padded(
    X, bin_mask, mesh, n_src, n_iter, model, proj_back, n_freq_total
):
    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(AXIS_MIX, None, AXIS_BINS, None), P(AXIS_BINS)),
        out_specs=P(AXIS_MIX, None, AXIS_BINS, None),
    )
    def run(Xl, maskl):
        sep = lambda x: _ip2_one(
            x, maskl, n_src, n_iter, model, n_freq_total, proj_back
        )
        return jax.vmap(sep)(Xl)

    return run(X, bin_mask)


def sharded_overiva_ip2(
    mesh, X_batch, n_src: int, n_iter: int = 10,
    model: str = "laplace", proj_back: bool = True,
):
    """Pairwise-update OverIVA over the mesh. X_batch: (B, T, F, M) complex;
    returns (B, T, F, n_src). Requires n_src >= 2."""
    if n_src < 2:
        raise ValueError("IP2 needs n_src >= 2")
    B, T, F, M = X_batch.shape
    n_mix = mesh.shape[AXIS_MIX]
    n_bins = mesh.shape[AXIS_BINS]
    if B % n_mix != 0:
        raise ValueError(f"batch {B} not divisible by mix axis {n_mix}")
    F_pad, mask = pad_bins(F, n_bins)
    if F_pad != F:
        reps = jnp.repeat(X_batch[:, :, -1:, :], F_pad - F, axis=2)
        X_batch = jnp.concatenate([X_batch, reps], axis=2)
    Y = _sharded_ip2_padded(
        X_batch, jnp.asarray(mask), mesh, int(n_src), int(n_iter), model,
        bool(proj_back), int(F),
    )
    return Y[:, :, :F, :]


def _ilrma_one(X, B0, H0, bin_mask, n_iter, n_freq_total, proj_back):
    """Per-shard, per-mixture ILRMA on the local bin slice."""
    T, Fl, M = X.shape
    W = jnp.tile(jnp.eye(M, dtype=X.dtype), (Fl, 1, 1))
    W = jax.lax.pcast(W, (AXIS_MIX, AXIS_BINS), to="varying")

    def epoch(_, s):
        return _ilrma._ilrma_epoch(
            X, s, axis_name=AXIS_BINS, n_freq=n_freq_total, bin_mask=bin_mask
        )

    W, B, H = jax.lax.fori_loop(0, n_iter, epoch, (W, B0, H0))
    Y = _core.demix(X, W)
    if proj_back:
        Y = _proj.apply_projection_back(Y, X[:, :, 0])
    return Y


@partial(
    jax.jit,
    static_argnames=("mesh", "n_iter", "proj_back", "n_freq_total"),
)
def _sharded_ilrma_padded(X, B0, H0, bin_mask, mesh, n_iter, proj_back, n_freq_total):
    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P(AXIS_MIX, None, AXIS_BINS, None),
            P(AXIS_MIX, None, AXIS_BINS, None),
            P(AXIS_MIX, None, None, None),
            P(AXIS_BINS),
        ),
        out_specs=P(AXIS_MIX, None, AXIS_BINS, None),
    )
    def run(Xl, B0l, H0l, maskl):
        sep = lambda x, b0, h0: _ilrma_one(
            x, b0, h0, maskl, n_iter, n_freq_total, proj_back
        )
        return jax.vmap(sep)(Xl, B0l, H0l)

    return run(X, B0, H0, bin_mask)


def sharded_ilrma(
    mesh,
    X_batch,
    n_iter: int = 20,
    n_components: int = 2,
    seed: int = 0,
    proj_back: bool = True,
):
    """Determined ILRMA over the mesh. X_batch: (B, T, F, M) complex.

    NMF init matches ``api.ilrma(seed=seed + b)`` per batch element; basis
    rows for padded bins replicate the last real bin (their contribution is
    masked out of the psum'd activation updates).
    """
    B, T, F, M = X_batch.shape
    n_mix = mesh.shape[AXIS_MIX]
    n_bins = mesh.shape[AXIS_BINS]
    if B % n_mix != 0:
        raise ValueError(f"batch {B} not divisible by mix axis {n_mix}")
    F_pad, mask = pad_bins(F, n_bins)
    if F_pad != F:
        reps = jnp.repeat(X_batch[:, :, -1:, :], F_pad - F, axis=2)
        X_batch = jnp.concatenate([X_batch, reps], axis=2)

    rdtype = np.float32 if X_batch.dtype == jnp.complex64 else np.float64
    B0 = np.empty((B, M, F_pad, n_components), rdtype)
    H0 = np.empty((B, M, n_components, T), rdtype)
    for b in range(B):
        rng = np.random.default_rng(seed + b)
        Bb = (rng.random((M, F, n_components)) + 0.1).astype(rdtype)
        B0[b, :, :F] = Bb
        B0[b, :, F:] = Bb[:, -1:, :]
        H0[b] = (rng.random((M, n_components, T)) + 0.1).astype(rdtype)

    # B stays real nonneg but the core multiplies into complex paths; keep f
    Y = _sharded_ilrma_padded(
        X_batch, jnp.asarray(B0), jnp.asarray(H0), jnp.asarray(mask),
        mesh, int(n_iter), bool(proj_back), int(F),
    )
    return Y[:, :, :F, :]


def _tip_one(
    X, bin_mask, taps, delay, n_iter, warm_iter, model, n_freq_total,
    proj_back, n_src=None,
):
    """Per-shard, per-mixture T-IP (warm-started by T-ISS epochs) on the
    local bin slice — single-psum family like _tiss_one."""
    T, Fl, M = X.shape
    Xt = _tiss.augment_taps(X, taps, delay)
    Pm = _tiss.augmented_eye(Xt, M)
    Pm = jax.lax.pcast(Pm, (AXIS_MIX, AXIS_BINS), to="varying")
    if warm_iter > 0 and taps > 0:
        Y = _core.demix(Xt, Pm)
        Pm, Y = jax.lax.fori_loop(
            0,
            warm_iter,
            lambda _, s: _tiss._tiss_epoch(
                Xt, s, model, M, axis_name=AXIS_BINS, n_freq=n_freq_total,
                bin_mask=bin_mask, n_src=n_src,
            ),
            (Pm, Y),
        )
    # background (phi = 1) pieces are run-constant and bin-local —
    # hoisted exactly as in models.tip.tip_iterations
    bg = None
    if n_src is not None and n_src < M:
        bg = _tip._background_pieces(Xt, M)
    Pm = jax.lax.fori_loop(
        0,
        n_iter,
        lambda _, p: _tip._tip_epoch(
            Xt, p, model, M, axis_name=AXIS_BINS, n_freq=n_freq_total,
            bin_mask=bin_mask, n_src=n_src, bg=bg,
        ),
        Pm,
    )
    Y = _core.demix(Xt, Pm)
    if n_src is not None:
        Y = Y[:, :, :n_src]
    if proj_back:
        Y = _proj.apply_projection_back(Y, X[:, :, 0])
    return Y


@partial(
    jax.jit,
    static_argnames=(
        "mesh", "taps", "delay", "n_iter", "warm_iter", "model", "proj_back",
        "n_freq_total", "n_src",
    ),
)
def _sharded_tip_padded(
    X, bin_mask, mesh, taps, delay, n_iter, warm_iter, model, proj_back,
    n_freq_total, n_src=None,
):
    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(AXIS_MIX, None, AXIS_BINS, None), P(AXIS_BINS)),
        out_specs=P(AXIS_MIX, None, AXIS_BINS, None),
    )
    def run(Xl, maskl):
        sep = lambda x: _tip_one(
            x, maskl, taps, delay, n_iter, warm_iter, model, n_freq_total,
            proj_back, n_src,
        )
        return jax.vmap(sep)(Xl)

    return run(X, bin_mask)


def sharded_tip(
    mesh,
    X_batch,
    n_src: int | None = None,
    taps: int = 5,
    delay: int = 2,
    n_iter: int = 10,
    warm_iter: int = 10,
    model: str = "laplace",
    proj_back: bool = True,
):
    """T-IP (joint dereverb + separation, exact IP rows) over the mesh.

    X_batch: (B, T, F, M) complex; returns (B, T, F, n_src or M)."""
    B, T, F, M = X_batch.shape
    n_mix = mesh.shape[AXIS_MIX]
    n_bins = mesh.shape[AXIS_BINS]
    if B % n_mix != 0:
        raise ValueError(f"batch {B} not divisible by mix axis {n_mix}")
    F_pad, mask = pad_bins(F, n_bins)
    if F_pad != F:
        reps = jnp.repeat(X_batch[:, :, -1:, :], F_pad - F, axis=2)
        X_batch = jnp.concatenate([X_batch, reps], axis=2)
    Y = _sharded_tip_padded(
        X_batch, jnp.asarray(mask), mesh, int(taps), int(delay), int(n_iter),
        int(warm_iter), model, bool(proj_back), int(F),
        None if n_src is None else int(n_src),
    )
    return Y[:, :, :F, :]


def _ilrma_t_one(X, B0, H0, bin_mask, taps, delay, n_iter, n_freq_total,
                 proj_back):
    """Per-shard, per-mixture ILRMA-T on the local bin slice (tap stack is
    bin-local; NMF activation + renorm psums as in _ilrma_one)."""
    T, Fl, M = X.shape
    Xt = _tiss.augment_taps(X, taps, delay)
    Pm = _tiss.augmented_eye(Xt, M)
    Pm = jax.lax.pcast(Pm, (AXIS_MIX, AXIS_BINS), to="varying")
    Y = _core.demix(Xt, Pm)

    def epoch(_, s):
        return _ilrma_t._ilrma_t_epoch(
            Xt, s, M, axis_name=AXIS_BINS, n_freq=n_freq_total,
            bin_mask=bin_mask,
        )

    Pm, Y, B, H = jax.lax.fori_loop(0, n_iter, epoch, (Pm, Y, B0, H0))
    if proj_back:
        Y = _proj.apply_projection_back(Y, X[:, :, 0])
    return Y


@partial(
    jax.jit,
    static_argnames=(
        "mesh", "taps", "delay", "n_iter", "proj_back", "n_freq_total"
    ),
)
def _sharded_ilrma_t_padded(
    X, B0, H0, bin_mask, mesh, taps, delay, n_iter, proj_back, n_freq_total
):
    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P(AXIS_MIX, None, AXIS_BINS, None),
            P(AXIS_MIX, None, AXIS_BINS, None),
            P(AXIS_MIX, None, None, None),
            P(AXIS_BINS),
        ),
        out_specs=P(AXIS_MIX, None, AXIS_BINS, None),
    )
    def run(Xl, B0l, H0l, maskl):
        sep = lambda x, b0, h0: _ilrma_t_one(
            x, b0, h0, maskl, taps, delay, n_iter, n_freq_total, proj_back
        )
        return jax.vmap(sep)(Xl, B0l, H0l)

    return run(X, B0, H0, bin_mask)


def sharded_ilrma_t(
    mesh,
    X_batch,
    taps: int = 5,
    delay: int = 2,
    n_iter: int = 20,
    n_components: int = 2,
    seed: int = 0,
    proj_back: bool = True,
):
    """Determined ILRMA-T (joint dereverb + ILRMA) over the mesh.

    X_batch: (B, T, F, M) complex; NMF init matches
    ``api.ilrma_t(seed=seed + b)`` per element (padded basis bins
    replicate the last real bin, masked out of the psums)."""
    B, T, F, M = X_batch.shape
    n_mix = mesh.shape[AXIS_MIX]
    n_bins = mesh.shape[AXIS_BINS]
    if B % n_mix != 0:
        raise ValueError(f"batch {B} not divisible by mix axis {n_mix}")
    F_pad, mask = pad_bins(F, n_bins)
    if F_pad != F:
        reps = jnp.repeat(X_batch[:, :, -1:, :], F_pad - F, axis=2)
        X_batch = jnp.concatenate([X_batch, reps], axis=2)

    rdtype = np.float32 if X_batch.dtype == jnp.complex64 else np.float64
    B0 = np.empty((B, M, F_pad, n_components), rdtype)
    H0 = np.empty((B, M, n_components, T), rdtype)
    for b in range(B):
        rng = np.random.default_rng(seed + b)
        Bb = (rng.random((M, F, n_components)) + 0.1).astype(rdtype)
        B0[b, :, :F] = Bb
        B0[b, :, F:] = Bb[:, -1:, :]
        H0[b] = (rng.random((M, n_components, T)) + 0.1).astype(rdtype)

    Y = _sharded_ilrma_t_padded(
        X_batch, jnp.asarray(B0), jnp.asarray(H0), jnp.asarray(mask),
        mesh, int(taps), int(delay), int(n_iter), bool(proj_back), int(F),
    )
    return Y[:, :, :F, :]


def _extract_one(X, bin_mask, n_iter, step_size, tol, model, update,
                 switch_every, n_freq_total, proj_back):
    """Per-shard, per-mixture OGIVE on the local bin slice."""
    T, Fl, M = X.shape
    w, a, Cx, Cx_inv = _ogive.ogive_init(X, init_eig=False)
    mesh_axes = (AXIS_MIX, AXIS_BINS)
    # constant-initialized carries must be typed varying over the mesh axes
    # before entering the while_loop (its body makes them data-dependent)
    w = jax.lax.pcast(w, mesh_axes, to="varying")
    use_mix = jax.lax.pcast(jnp.zeros((Fl,), bool), mesh_axes, to="varying")
    w, a, use_mix, epoch, done = _ogive.ogive_iterations(
        X, w, a, use_mix, Cx, Cx_inv,
        jnp.asarray(0, jnp.int32),
        jnp.asarray(step_size, X.real.dtype),
        jnp.asarray(tol, X.real.dtype),
        n_iter, model, update, switch_every,
        axis_name=AXIS_BINS, n_freq=n_freq_total, bin_mask=bin_mask,
        done_pvary_axes=(AXIS_MIX,),
    )
    Y = _ogive.ogive_demix(X, w)[:, :, None]
    if proj_back:
        Y = _proj.apply_projection_back(Y, X[:, :, 0])
    return Y


@partial(
    jax.jit,
    static_argnames=(
        "mesh", "n_iter", "model", "update", "switch_every", "proj_back", "n_freq_total"
    ),
)
def _sharded_ogive_padded(
    X, bin_mask, step_size, tol, mesh, n_iter, model, update, switch_every,
    proj_back, n_freq_total,
):
    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(AXIS_MIX, None, AXIS_BINS, None), P(AXIS_BINS)),
        out_specs=P(AXIS_MIX, None, AXIS_BINS, None),
    )
    def run(Xl, maskl):
        ext = lambda x: _extract_one(
            x, maskl, n_iter, step_size, tol, model, update, switch_every,
            n_freq_total, proj_back,
        )
        return jax.vmap(ext)(Xl)

    return run(X, bin_mask)


def sharded_ogive(
    mesh,
    X_batch,
    n_iter: int = 4000,
    step_size: float = 0.1,
    tol: float = 1e-3,
    model: str = "laplace",
    update: str = "demix",
    switch_every: int = 10,
    proj_back: bool = True,
):
    """OGIVE extraction of a batch of mixtures over the mesh.

    X_batch: (B, T, F, M) complex. Returns Y: (B, T, F, 1). Convergence is
    global: the per-iteration max step is pmax'd over the bins axis, so all
    shards stop together, exactly like the single-device path.
    """
    B, T, F, M = X_batch.shape
    n_mix = mesh.shape[AXIS_MIX]
    n_bins = mesh.shape[AXIS_BINS]
    if B % n_mix != 0:
        raise ValueError(f"batch {B} not divisible by mix axis {n_mix}")
    F_pad, mask = pad_bins(F, n_bins)
    if F_pad != F:
        reps = jnp.repeat(X_batch[:, :, -1:, :], F_pad - F, axis=2)
        X_batch = jnp.concatenate([X_batch, reps], axis=2)
    Y = _sharded_ogive_padded(
        X_batch, jnp.asarray(mask), jnp.asarray(step_size), jnp.asarray(tol),
        mesh, int(n_iter), model, update, int(switch_every), bool(proj_back),
        int(F),
    )
    return Y[:, :, :F, :]


def sharded_overiva(
    mesh,
    X_batch,
    n_src: int,
    n_iter: int = 20,
    model: str = "laplace",
    proj_back: bool = True,
):
    """Separate a batch of mixtures over the mesh. Trace-side complex in/out.

    X_batch: (B, T, F, M) complex, B divisible by the 'mix' axis size.
    Returns Y: (B, T, F, n_src).
    """
    B, T, F, M = X_batch.shape
    n_mix = mesh.shape[AXIS_MIX]
    n_bins = mesh.shape[AXIS_BINS]
    if B % n_mix != 0:
        raise ValueError(f"batch {B} not divisible by mix axis {n_mix}")

    F_pad, mask = pad_bins(F, n_bins)
    if F_pad != F:
        # replicate the last bin: keeps every shard's solves well-conditioned
        last = X_batch[:, :, -1:, :]
        reps = jnp.repeat(last, F_pad - F, axis=2)
        X_batch = jnp.concatenate([X_batch, reps], axis=2)
    Y = _sharded_overiva_padded(
        X_batch,
        jnp.asarray(mask),
        mesh,
        int(n_src),
        int(n_iter),
        model,
        bool(proj_back),
        int(F),
    )
    return Y[:, :, :F, :]

def _pca_one(X, bin_mask, n_src, n_iter, model, n_freq_total, proj_back):
    """Per-shard, per-mixture PCA + determined AuxIVA on the local bins.

    The per-bin eigh reduction is bin-LOCAL (SURVEY.md §2.3.5), so the
    only collective stays the (T, N) activation psum of the inner AuxIVA;
    projection back targets the ORIGINAL local mic 0 (reference
    convention, api.auxiva_pca)."""
    T, Fl, M = X.shape
    N = n_src
    X_r = _pca_mod.pca(X, N) if N < M else X
    W_hat = _core.init_w_hat(X_r, N, init_eig=False)
    # identity init is a shard-constant: give it the loop body's
    # varying-axes type (same as _iss_one)
    W_hat = jax.lax.pcast(W_hat, (AXIS_MIX, AXIS_BINS), to="varying")
    Cx0 = jnp.zeros((Fl, N, N), X_r.dtype)  # unused: determined inner

    def epoch(_, W):
        return _core._epoch(
            X_r, W, Cx0, N, model,
            axis_name=AXIS_BINS, n_freq=n_freq_total, bin_mask=bin_mask,
        )

    W_hat = jax.lax.fori_loop(0, n_iter, epoch, W_hat)
    Y = _core.demix(X_r, W_hat)
    if proj_back:
        Y = _proj.apply_projection_back(Y, X[:, :, 0])
    return Y


@partial(
    jax.jit,
    static_argnames=(
        "mesh", "n_src", "n_iter", "model", "proj_back", "n_freq_total"
    ),
)
def _sharded_pca_padded(
    X, bin_mask, mesh, n_src, n_iter, model, proj_back, n_freq_total
):
    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(AXIS_MIX, None, AXIS_BINS, None), P(AXIS_BINS)),
        out_specs=P(AXIS_MIX, None, AXIS_BINS, None),
    )
    def run(Xl, maskl):
        sep = lambda x: _pca_one(
            x, maskl, n_src, n_iter, model, n_freq_total, proj_back
        )
        return jax.vmap(sep)(Xl)

    return run(X, bin_mask)


def sharded_auxiva_pca(
    mesh,
    X_batch,
    n_src: int,
    n_iter: int = 20,
    model: str = "laplace",
    proj_back: bool = True,
):
    """PCA + determined AuxIVA over the mesh (SURVEY.md §2.3.5).

    X_batch: (B, T, F, M) complex, B divisible by the 'mix' axis size.
    Returns Y: (B, T, F, n_src)."""
    B, T, F, M = X_batch.shape
    n_mix = mesh.shape[AXIS_MIX]
    n_bins = mesh.shape[AXIS_BINS]
    if B % n_mix != 0:
        raise ValueError(f"batch {B} not divisible by mix axis {n_mix}")
    F_pad, mask = pad_bins(F, n_bins)
    if F_pad != F:
        reps = jnp.repeat(X_batch[:, :, -1:, :], F_pad - F, axis=2)
        X_batch = jnp.concatenate([X_batch, reps], axis=2)
    Y = _sharded_pca_padded(
        X_batch, jnp.asarray(mask), mesh, int(n_src), int(n_iter), model,
        bool(proj_back), int(F),
    )
    return Y[:, :, :F, :]


def _fastmnmf2_one(X, g0, W0, H0, bin_mask, n_iter, mic_index, n_out):
    """Per-shard, per-mixture FastMNMF1/2 on the local bin slice.

    Per-bin work (W/Q updates, whitening init, Wiener) is local; the
    frequency-reduced NMF/spatial statistics psum over AXIS_BINS inside
    the epoch (models/fastmnmf2._epoch). FastMNMF1's untied g (N, F, M)
    arrives bin-sharded and its update is per-frequency — fully local, so
    the untied variant actually needs ONE FEWER psum pair per epoch.
    Output-slot selection uses the GLOBAL image energies so every shard
    picks the same sources."""
    Q = _fmnmf.whiten_q(X)
    # tied g is replicated (constant over both axes) and must be marked
    # varying; untied g is already bin-sharded (varying over AXIS_BINS)
    pcast_axes = (AXIS_MIX, AXIS_BINS) if g0.ndim == 2 else (AXIS_MIX,)
    g0 = jax.lax.pcast(g0, pcast_axes, to="varying")
    Q, g, W, H = _fmnmf.fastmnmf2_iterations(
        X, Q, g0, W0, H0, n_iter, axis_name=AXIS_BINS, bin_mask=bin_mask
    )
    Y = _fmnmf.fastmnmf2_wiener(X, Q, g, W, H, mic_index)
    if n_out < Y.shape[2]:
        en = jnp.sum(jnp.abs(Y) ** 2 * bin_mask[None, :, None], axis=(0, 1))
        en = jax.lax.psum(en, AXIS_BINS)
        pick = jnp.sort(jnp.argsort(-en)[:n_out])
        Y = jnp.take_along_axis(Y, pick[None, None, :], axis=2)
    return Y


@partial(
    jax.jit,
    static_argnames=("mesh", "n_iter", "mic_index", "n_out"),
)
def _sharded_fastmnmf2_padded(X, g0, W0, H0, bin_mask, mesh, n_iter,
                              mic_index, n_out):
    g_spec = P(None, None) if g0.ndim == 2 else P(None, AXIS_BINS, None)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P(AXIS_MIX, None, AXIS_BINS, None),
            g_spec,
            P(AXIS_MIX, None, AXIS_BINS, None),
            P(AXIS_MIX, None, None, None),
            P(AXIS_BINS),
        ),
        out_specs=P(AXIS_MIX, None, AXIS_BINS, None),
    )
    def run(Xl, g0l, W0l, H0l, maskl):
        sep = lambda x, w0, h0: _fastmnmf2_one(
            x, g0l, w0, h0, maskl, n_iter, mic_index, n_out
        )
        return jax.vmap(sep)(Xl, W0l, H0l)

    return run(X, g0, W0, H0, bin_mask)


def sharded_fastmnmf2(
    mesh,
    X_batch,
    n_src: int | None = None,
    n_iter: int = 30,
    n_components: int = 2,
    mic_index: int = 0,
    n_noise="auto",
    seed: int = 0,
    tie_g: bool = True,
):
    """FastMNMF2 (or FastMNMF1 with ``tie_g=False``) over the mesh.
    X_batch: (B, T, F, M) complex.

    NMF init matches ``api.fastmnmf2(seed=seed + b)`` per batch element
    (padded bins replicate the last real bin's basis rows; their
    contributions are masked out of the psum'd statistics). FastMNMF1's
    per-frequency g is sharded over the bins axis and updates locally."""
    B, T, F, M = X_batch.shape
    N_out = M if n_src is None else int(n_src)
    if n_noise == "auto":
        n_noise = M - N_out if N_out < M else 0
    N = N_out + int(n_noise)
    n_mix = mesh.shape[AXIS_MIX]
    n_bins = mesh.shape[AXIS_BINS]
    if B % n_mix != 0:
        raise ValueError(f"batch {B} not divisible by mix axis {n_mix}")
    # per-mixture unit-power normalization (models.fastmnmf2.unit_power),
    # done on the full unpadded tensor so it matches the single-device path
    x_scale = jnp.sqrt(
        jnp.mean(jnp.abs(X_batch) ** 2, axis=(1, 2, 3), keepdims=True)
    )
    x_scale = jnp.where(x_scale > 0, x_scale, 1.0).astype(X_batch.real.dtype)
    X_batch = X_batch / x_scale
    F_pad, mask = pad_bins(F, n_bins)
    if F_pad != F:
        reps = jnp.repeat(X_batch[:, :, -1:, :], F_pad - F, axis=2)
        X_batch = jnp.concatenate([X_batch, reps], axis=2)

    rdtype = np.float32 if X_batch.dtype == jnp.complex64 else np.float64
    g0 = np.full((N, M), 1e-2)
    for n in range(N):
        g0[n, n % M] = 1.0
    g0 /= g0.sum(axis=1, keepdims=True)
    if not tie_g:  # FastMNMF1: per-frequency g, sharded over bins
        g0 = np.tile(g0[:, None, :], (1, F_pad, 1))
    W0 = np.empty((B, N, F_pad, n_components), rdtype)
    H0 = np.empty((B, N, n_components, T), rdtype)
    for b in range(B):
        rng = np.random.default_rng(seed + b)
        Wb = (rng.random((N, F, n_components)) + 0.1).astype(rdtype)
        W0[b, :, :F] = Wb
        W0[b, :, F:] = Wb[:, -1:, :]
        H0[b] = (rng.random((N, n_components, T)) + 0.1).astype(rdtype)

    Y = _sharded_fastmnmf2_padded(
        X_batch, jnp.asarray(g0.astype(rdtype)), jnp.asarray(W0),
        jnp.asarray(H0), jnp.asarray(mask), mesh, int(n_iter),
        int(mic_index), int(N_out),
    )
    return Y[:, :, :F, :] * x_scale


# --------------------------------------------------------------- FIVE

def _five_one(X, bin_mask, n_iter, model, n_freq_total, proj_back):
    """Per-shard, per-mixture FIVE on the local bin slice: whitening,
    min-eigenvector epochs and phase fixing are per-bin local; the
    activation power psums over AXIS_BINS (models/five.five_iterations)."""
    Fl, M = X.shape[1], X.shape[2]
    Xw, _ = _five.five_whiten(X)
    w = jnp.zeros((Fl, M), X.dtype).at[:, 0].set(1.0)
    w = jax.lax.pcast(w, (AXIS_MIX, AXIS_BINS), to="varying")
    w = _five.five_iterations(
        Xw, w, n_iter, model,
        axis_name=AXIS_BINS, n_freq=n_freq_total, bin_mask=bin_mask,
    )
    Y = _five.five_demix(Xw, w)[:, :, None]
    if proj_back:
        Y = _proj.apply_projection_back(Y, X[:, :, 0])
    return Y


@partial(
    jax.jit,
    static_argnames=("mesh", "n_iter", "model", "proj_back", "n_freq_total"),
)
def _sharded_five_padded(X, bin_mask, mesh, n_iter, model, proj_back,
                         n_freq_total):
    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(AXIS_MIX, None, AXIS_BINS, None), P(AXIS_BINS)),
        out_specs=P(AXIS_MIX, None, AXIS_BINS, None),
    )
    def run(Xl, maskl):
        sep = lambda x: _five_one(
            x, maskl, n_iter, model, n_freq_total, proj_back
        )
        return jax.vmap(sep)(Xl)

    return run(X, bin_mask)


def sharded_five(
    mesh,
    X_batch,
    n_iter: int = 10,
    model: str = "laplace",
    proj_back: bool = True,
):
    """FIVE single-source extraction of a batch of mixtures over the mesh.

    X_batch: (B, T, F, M) complex. Returns Y: (B, T, F, 1). Matches
    ``api.five`` per batch element (tests/test_sharding.py)."""
    B, T, F, M = X_batch.shape
    n_mix = mesh.shape[AXIS_MIX]
    n_bins = mesh.shape[AXIS_BINS]
    if B % n_mix != 0:
        raise ValueError(f"batch {B} not divisible by mix axis {n_mix}")
    F_pad, mask = pad_bins(F, n_bins)
    if F_pad != F:
        reps = jnp.repeat(X_batch[:, :, -1:, :], F_pad - F, axis=2)
        X_batch = jnp.concatenate([X_batch, reps], axis=2)
    Y = _sharded_five_padded(
        X_batch, jnp.asarray(mask), mesh, int(n_iter), model,
        bool(proj_back), int(F),
    )
    return Y[:, :, :F, :]


# -------------------------------------------------------- SparseAuxIVA

def _sparse_ip_one(X, bin_mask, n_iter, model, k_total):
    """Phase 1: determined IP on the (sharded) selected-bin slice. Returns
    the per-bin demixing W (F_local, M, M); the activation power psums
    over the selected-bin shard axis, everything else is bin-local."""
    M = X.shape[2]
    W = _core.init_w_hat(X, M, init_eig=False)  # identity (determined)
    W = jax.lax.pcast(W, (AXIS_MIX, AXIS_BINS), to="varying")

    def epoch(_, W):
        return _core._epoch(
            X, W, None, M, model,
            axis_name=AXIS_BINS, n_freq=k_total, bin_mask=bin_mask,
        )

    return jax.lax.fori_loop(0, n_iter, epoch, W)


@partial(jax.jit, static_argnames=("mesh", "n_iter", "model", "k_total"))
def _sharded_sparse_ip(Xs, bin_mask, mesh, n_iter, model, k_total):
    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(AXIS_MIX, None, AXIS_BINS, None), P(AXIS_BINS)),
        out_specs=P(AXIS_MIX, AXIS_BINS, None, None),
    )
    def run(Xl, maskl):
        return jax.vmap(
            lambda x: _sparse_ip_one(x, maskl, n_iter, model, k_total)
        )(Xl)

    return run(Xs, bin_mask)


def _sparse_rec_one(
    X, Ws, S, bin_mask, F, nfft, n_causal, n_acausal, lasso_iter, lam_ratio,
    polish_iter, model, proj_back,
):
    """Phase 2+3: LASSO reconstruction + warm polish on the local bins.

    Ws/S arrive replicated (the one k-bin gather the algorithm needs):
    the FISTA GEMMs run replicated per shard (they are
    tiny), then each shard keeps only its local slice of the recovered
    full-band RTFs, overwrites the measured bins that fall in its range,
    inverts, and polishes with the standard single-psum IP epochs."""
    T, Fl, M = X.shape
    R_s = _sparse.sparse_rtfs(Ws)
    g_full = _sparse.sparse_rtf_taps(
        R_s, S, nfft, n_causal, n_acausal, lasso_iter, lam_ratio,
        pvary_axes=(AXIS_MIX,),
    )
    R_rec = jnp.fft.rfft(g_full, axis=-1).astype(X.dtype)  # (M(M-1), F)
    offset = jax.lax.axis_index(AXIS_BINS) * Fl
    # padded local bins (global index >= F) replicate bin F-1, consistent
    # with the replicate-padded X data
    idx = jnp.clip(offset + jnp.arange(Fl), 0, F - 1)
    R_loc = jnp.take(R_rec, idx, axis=1)
    A_loc = jnp.concatenate(
        [
            jnp.ones((Fl, 1, M), X.dtype),
            jnp.transpose(R_loc.reshape(M, M - 1, Fl), (2, 1, 0)),
        ],
        axis=1,
    )
    # measured bins verbatim: scatter the rows of R_s that fall locally
    # (out-of-range rows land on a sacrificial row Fl and are sliced off)
    local_S = S.astype(jnp.int32) - offset
    valid = (local_S >= 0) & (local_S < Fl)
    tgt = jnp.where(valid, local_S, Fl)
    A_pad = jnp.concatenate([A_loc, jnp.zeros((1, M, M), X.dtype)], axis=0)
    A_loc = A_pad.at[tgt].set(R_s.astype(X.dtype))[:Fl]
    W = small_inv(A_loc)

    def epoch(_, W):
        return _core._epoch(
            X, W, None, M, model,
            axis_name=AXIS_BINS, n_freq=F, bin_mask=bin_mask,
        )

    W = jax.lax.fori_loop(0, polish_iter, epoch, W)
    Y = _core.demix(X, W)
    if proj_back:
        Y = _proj.apply_projection_back(Y, X[:, :, 0])
    return Y


@partial(
    jax.jit,
    static_argnames=(
        "mesh", "F", "nfft", "n_causal", "n_acausal", "lasso_iter",
        "polish_iter", "model", "proj_back",
    ),
)
def _sharded_sparse_rec(
    X, Ws, S, bin_mask, lam_ratio, mesh, F, nfft, n_causal, n_acausal,
    lasso_iter, polish_iter, model, proj_back,
):
    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P(AXIS_MIX, None, AXIS_BINS, None),
            P(AXIS_MIX, None, None, None),
            P(AXIS_MIX, None),
            P(AXIS_BINS),
        ),
        out_specs=P(AXIS_MIX, None, AXIS_BINS, None),
    )
    def run(Xl, Wsl, Sl, maskl):
        sep = lambda x, ws, s: _sparse_rec_one(
            x, ws, s, maskl, F, nfft, n_causal, n_acausal, lasso_iter,
            lam_ratio, polish_iter, model, proj_back,
        )
        return jax.vmap(sep)(Xl, Wsl, Sl)

    return run(X, Ws, S, bin_mask)


def sharded_sparseauxiva(
    mesh,
    X_batch,
    S=None,
    n_bins=None,
    n_iter: int = 20,
    model: str = "laplace",
    lasso_iter: int = 300,
    lasso_lam: float = 0.05,
    filter_taps=None,
    acausal_taps=None,
    polish_iter: int = 3,
    proj_back: bool = True,
):
    """SparseAuxIVA (determined) over the mesh. X_batch: (B, T, F, M)
    complex; returns (B, T, F, M). Matches ``api.sparseauxiva`` per batch
    element.

    Comm design (SURVEY.md §2.4/§5.8): phase 1 runs IP on the selected-bin
    slice, itself bin-sharded with the usual one power psum per epoch;
    phase 2 gathers the k measured bins' demixing matrices to every shard
    (one small (k, M, M) all-gather — inserted by XLA at the resharding
    boundary between the two shard_map programs), runs the FISTA GEMMs
    replicated, and keeps only local bins; phase 3 polish is the standard
    single-psum epoch loop.

    ``S``: (k,) shared or (B, k) per-element bin selection; defaults to
    the stratified top-power selection computed per element."""
    from ..oracle.sparseauxiva import _resolve_n_bins, select_bins

    B, T, F, M = X_batch.shape
    n_mix = mesh.shape[AXIS_MIX]
    n_bins_shards = mesh.shape[AXIS_BINS]
    if B % n_mix != 0:
        raise ValueError(f"batch {B} not divisible by mix axis {n_mix}")
    nfft = 2 * (F - 1)
    n_causal = nfft // 4 if filter_taps is None else int(filter_taps)
    n_acausal = nfft // 16 if acausal_taps is None else int(acausal_taps)

    if S is None:
        k = _resolve_n_bins(n_bins, F, M)
        S_arr = np.stack(
            [select_bins(np.asarray(X_batch[b]), k) for b in range(B)]
        )
    else:
        S_arr = np.asarray(S, np.int64)
        if S_arr.ndim == 1:
            S_arr = np.tile(S_arr[None, :], (B, 1))
        if S_arr.shape[0] != B:
            raise ValueError("S must be (k,) or (B, k)")
        if (
            S_arr.shape[1] == 0
            or S_arr.min() < 0
            or S_arr.max() >= F
            or np.any(np.diff(S_arr, axis=1) <= 0)
        ):
            raise ValueError(
                "each S row must be strictly increasing bin indices < F"
            )
    k = S_arr.shape[1]
    if k >= F:
        raise ValueError("all bins selected: use sharded_overiva instead")

    # ---- phase 1: IP on the selected bins, sharded over the k axis ----
    k_pad, k_mask = pad_bins(k, n_bins_shards)
    S_pad = np.concatenate(
        [S_arr, np.tile(S_arr[:, -1:], (1, k_pad - k))], axis=1
    )
    Xs = jnp.take_along_axis(
        X_batch, jnp.asarray(S_pad)[:, None, :, None], axis=2
    )  # (B, T, k_pad, M)
    W_all = _sharded_sparse_ip(
        Xs, jnp.asarray(k_mask), mesh, int(n_iter), model, int(k)
    )
    Ws = W_all[:, :k]  # (B, k, M, M)

    # ---- phases 2+3: reconstruction + polish on the full bin axis ----
    F_pad, mask = pad_bins(F, n_bins_shards)
    if F_pad != F:
        reps = jnp.repeat(X_batch[:, :, -1:, :], F_pad - F, axis=2)
        X_batch = jnp.concatenate([X_batch, reps], axis=2)
    rdtype = np.float32 if X_batch.dtype == jnp.complex64 else np.float64
    Y = _sharded_sparse_rec(
        X_batch, Ws, jnp.asarray(S_arr, jnp.int32), jnp.asarray(mask),
        jnp.asarray(lasso_lam, rdtype), mesh, int(F), int(nfft),
        int(n_causal), int(n_acausal), int(lasso_iter), int(polish_iter),
        model, bool(proj_back),
    )
    return Y[:, :, :F, :]


# ------------------------------------------------------------------- WPE

@partial(
    jax.jit,
    static_argnames=("mesh", "taps", "delay", "n_iter", "diag_load"),
)
def _sharded_wpe_padded(X, mesh, taps, delay, n_iter, diag_load):
    @partial(
        shard_map,
        mesh=mesh,
        in_specs=P(AXIS_MIX, None, AXIS_BINS, None),
        out_specs=P(AXIS_MIX, None, AXIS_BINS, None),
    )
    def run(Xl):
        f = lambda x: _wpe.wpe(
            x, taps=taps, delay=delay, n_iter=n_iter, diag_load=diag_load
        )
        return jax.vmap(f)(Xl)

    return run(X)


def sharded_wpe(
    mesh,
    X_batch,
    taps: int = 10,
    delay: int = 3,
    n_iter: int = 3,
    diag_load: float = 1e-5,
):
    """WPE-dereverberate a batch of mixtures over the mesh.

    X_batch: (B, T, F, M) complex -> (B, T, F, M). WPE is the
    embarrassingly-parallel member of the family: the PSD estimate ``lam``
    is a per-(t, f) mean over mics, so every frequency bin is fully local —
    ZERO collectives on either mesh axis (SURVEY.md §2.4/§5.8 pattern,
    degenerate case). Padded bins replicate the last bin (well-conditioned
    solves) and are sliced off on the way out; no power masking is needed
    because nothing is reduced across bins.
    """
    B, T, F, M = X_batch.shape
    n_mix = mesh.shape[AXIS_MIX]
    n_bins = mesh.shape[AXIS_BINS]
    if B % n_mix != 0:
        raise ValueError(f"batch {B} not divisible by mix axis {n_mix}")
    F_pad, _ = pad_bins(F, n_bins)
    if F_pad != F:
        reps = jnp.repeat(X_batch[:, :, -1:, :], F_pad - F, axis=2)
        X_batch = jnp.concatenate([X_batch, reps], axis=2)
    Y = _sharded_wpe_padded(
        X_batch, mesh, int(taps), int(delay), int(n_iter), float(diag_load)
    )
    return Y[:, :, :F, :]


# ---------------------------------------------------------------- streaming

def _online_iss_one(X, bin_mask, block, forget, model, n_pass, n_freq_total,
                    pb_forget):
    """Per-shard, per-stream online ISS over the local bin slice: a
    lax.scan over fixed-size blocks carrying the streaming state, with
    the per-pass (B, M) power psum as the ONE cross-bin collective (the
    same budget as the batch _iss_epoch)."""
    from ..models.online_iss import online_iss_init, online_iss_step

    T, Fl, M = X.shape
    state = online_iss_init(Fl, M, X.dtype)
    # constant init must carry the same varying-axes type as the scan body
    state = {k: jax.lax.pcast(v, (AXIS_MIX, AXIS_BINS), to="varying")
             for k, v in state.items()}
    Xb = X.reshape(T // block, block, Fl, M)

    def step(st, xb):
        Y, st = online_iss_step(
            xb, st, forget, model, n_pass, pb_forget=pb_forget,
            axis_name=AXIS_BINS, n_freq=n_freq_total, bin_mask=bin_mask,
        )
        return st, Y

    _, Ys = jax.lax.scan(step, state, Xb)
    return Ys.reshape(T, Fl, M)


@partial(
    jax.jit,
    static_argnames=("mesh", "block", "model", "n_pass", "n_freq_total"),
)
def _sharded_online_iss_padded(
    X, bin_mask, forget, pb_forget, mesh, block, model, n_pass, n_freq_total
):
    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(AXIS_MIX, None, AXIS_BINS, None), P(AXIS_BINS)),
        out_specs=P(AXIS_MIX, None, AXIS_BINS, None),
    )
    def run(Xl, maskl):
        sep = lambda x: _online_iss_one(
            x, maskl, block, forget, model, n_pass, n_freq_total, pb_forget
        )
        return jax.vmap(sep)(Xl)

    return run(X, bin_mask)


def sharded_online_iss(
    mesh,
    X_batch,
    block: int,
    forget: float = 0.97,
    model: str = "laplace",
    n_pass: int = 1,
    pb_forget: float | None = None,
):
    """Streaming (online) AuxIVA-ISS over the mesh: a batch of B parallel
    streams data-parallel on the 'mix' axis AND bin-sharded on 'bins',
    processed block-wise with exponentially-forgotten statistics.

    X_batch: (B, T, F, M) complex with T divisible by ``block``; returns
    (B, T, F, M) — per-stream results match feeding the same blocks
    through ``api.OnlineAuxIVAISS`` / the NumPy oracle
    (``oracle/online_iss.py``). The scan carries the streaming state
    entirely on device; each pass costs ONE (block, M) psum across bins.
    """
    B, T, F, M = X_batch.shape
    if T % int(block) != 0:
        raise ValueError(f"stream length {T} not divisible by block {block}")
    n_mix = mesh.shape[AXIS_MIX]
    n_bins = mesh.shape[AXIS_BINS]
    if B % n_mix != 0:
        raise ValueError(f"batch {B} not divisible by mix axis {n_mix}")
    F_pad, mask = pad_bins(F, n_bins)
    if F_pad != F:
        reps = jnp.repeat(X_batch[:, :, -1:, :], F_pad - F, axis=2)
        X_batch = jnp.concatenate([X_batch, reps], axis=2)
    rdt = jnp.finfo(X_batch.dtype).dtype
    fj = jnp.asarray(forget, rdt)
    pbj = fj if pb_forget is None else jnp.asarray(pb_forget, rdt)
    Y = _sharded_online_iss_padded(
        X_batch, jnp.asarray(mask), fj, pbj, mesh, int(block), model,
        int(n_pass), int(F),
    )
    return Y[:, :, :F, :]


def _online_tiss_one(X, bin_mask, block, forget, taps, delay, model, n_pass,
                     n_freq_total, pb_forget, tap_forget, tap_update,
                     diag_load):
    """Per-shard, per-stream online T-ISS over the local bin slice: a
    lax.scan over fixed-size blocks carrying the joint streaming state.
    The per-pass (B, M) power psum is the ONE cross-bin collective — the
    tap normal-equation solve (Rz/rp, models/online_tiss.py) is per-bin
    by construction, so joint dereverberation adds ZERO collectives over
    the plain online-ISS budget."""
    from ..models.online_tiss import online_tiss_init, online_tiss_step

    T, Fl, M = X.shape
    state = online_tiss_init(Fl, M, taps, delay, tap_update, X.dtype)
    # constant init must carry the same varying-axes type as the scan body
    state = {k: jax.lax.pcast(v, (AXIS_MIX, AXIS_BINS), to="varying")
             for k, v in state.items()}
    Xb = X.reshape(T // block, block, Fl, M)

    def step(st, xb):
        Y, st = online_tiss_step(
            xb, st, forget, taps=taps, delay=delay, model=model,
            n_pass=n_pass, pb_forget=pb_forget, tap_update=tap_update,
            diag_load=diag_load, tap_forget=tap_forget,
            axis_name=AXIS_BINS, n_freq=n_freq_total, bin_mask=bin_mask,
        )
        return st, Y

    _, Ys = jax.lax.scan(step, state, Xb)
    return Ys.reshape(T, Fl, M)


@partial(
    jax.jit,
    static_argnames=("mesh", "block", "taps", "delay", "model", "n_pass",
                     "tap_update", "n_freq_total"),
)
def _sharded_online_tiss_padded(
    X, bin_mask, forget, pb_forget, tap_forget, diag_load, mesh, block,
    taps, delay, model, n_pass, tap_update, n_freq_total,
):
    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(AXIS_MIX, None, AXIS_BINS, None), P(AXIS_BINS)),
        out_specs=P(AXIS_MIX, None, AXIS_BINS, None),
    )
    def run(Xl, maskl):
        sep = lambda x: _online_tiss_one(
            x, maskl, block, forget, taps, delay, model, n_pass,
            n_freq_total, pb_forget, tap_forget, tap_update, diag_load,
        )
        return jax.vmap(sep)(Xl)

    return run(X, bin_mask)


def sharded_online_tiss(
    mesh,
    X_batch,
    block: int,
    taps: int = 4,
    delay: int = 2,
    forget: float = 0.97,
    model: str = "laplace",
    n_pass: int = 1,
    pb_forget: float | None = None,
    tap_forget: float | None = None,
    tap_update: str = "solve",
    diag_load: float = 1e-5,
):
    """Streaming JOINT dereverb + separation (online T-ISS) over the mesh:
    a batch of B parallel streams data-parallel on the 'mix' axis AND
    bin-sharded on 'bins', processed block-wise.

    X_batch: (B, T, F, M) complex with T divisible by ``block``; returns
    (B, T, F, M) — per-stream results match feeding the same blocks
    through ``api.OnlineTISS`` (``models/online_tiss.py``). Collective
    budget is identical to :func:`sharded_online_iss` (one (block, M)
    power psum per pass): the tap statistics Rz/rp and their
    normal-equation solve are per-bin, so the dereverberation adds no
    cross-chip traffic.
    """
    B, T, F, M = X_batch.shape
    if T % int(block) != 0:
        raise ValueError(f"stream length {T} not divisible by block {block}")
    if tap_update not in ("solve", "steer"):
        raise ValueError("tap_update must be 'solve' or 'steer'")
    n_mix = mesh.shape[AXIS_MIX]
    n_bins = mesh.shape[AXIS_BINS]
    if B % n_mix != 0:
        raise ValueError(f"batch {B} not divisible by mix axis {n_mix}")
    F_pad, mask = pad_bins(F, n_bins)
    if F_pad != F:
        reps = jnp.repeat(X_batch[:, :, -1:, :], F_pad - F, axis=2)
        X_batch = jnp.concatenate([X_batch, reps], axis=2)
    rdt = jnp.finfo(X_batch.dtype).dtype
    fj = jnp.asarray(forget, rdt)
    pbj = fj if pb_forget is None else jnp.asarray(pb_forget, rdt)
    tapj = fj if tap_forget is None else jnp.asarray(tap_forget, rdt)
    dlj = jnp.asarray(diag_load, rdt)
    Y = _sharded_online_tiss_padded(
        X_batch, jnp.asarray(mask), fj, pbj, tapj, dlj, mesh, int(block),
        int(taps), int(delay), model, int(n_pass), tap_update, int(F),
    )
    return Y[:, :, :F, :]
