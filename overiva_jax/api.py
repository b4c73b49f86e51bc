"""Public reference-mirroring API: NumPy in, NumPy out, XLA inside.

Signatures mirror the reference repo (SURVEY.md §2.1: ``overiva.py``,
``ive.py``, ``auxiva_pca.py``, ``pyroomacoustics.bss.auxiva`` /
``transform.stft`` / ``bss.common.projection_back``):

    overiva(X, n_src, n_iter, proj_back, W0, model, init_eig,
            return_filters, callback) -> Y
    auxiva(...), ogive(...), auxiva_pca(...), projection_back(Y, ref),
    stft_analysis / stft_synthesis

Inputs/outputs are NumPy arrays shaped like the reference's
(``(n_frames, n_freq, n_chan)`` complex STFT). Internally everything runs as
fused XLA programs; complex values cross the host<->device boundary as
float planes merged/split by tiny jitted shims (``utils/packing.py``).

Callback compatibility (SURVEY.md §7.2): when a ``callback`` is given, the
run is jitted in chunks of ``callback_every`` epochs; between chunks the
host receives a projection-back-scaled NumPy copy of Y, exactly like the
reference's cadence. With ``callback=None`` one XLA program covers all
epochs.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from .models import auxiva_pca as _pca_mod
from .models import ogive as _ogive_mod
from .models import overiva as _core
from .models import overiva_df as _dfcore
from .ops import projection as _proj
from .ops import stft as _stft
from .ops import wpe as _wpe_mod
from .ops.covariance import WCOV_MODES
from .ops.covariance import covariance as _covariance
from .utils.packing import merge_np, real_dtype_of, split_np

__all__ = [
    "auxiva",
    "overiva",
    "ogive",
    "auxiva_pca",
    "pca",
    "projection_back",
    "stft_analysis",
    "stft_analysis_batch",
    "stft_synthesis",
    "stft_synthesis_batch",
    "to_device",
    "overiva_batch",
    "separate",
    "auxiva_iss",
    "five",
    "OnlineAuxIVAISS",
    "ilrma",
    "fastmnmf",
    "fastmnmf2",
    "sparseauxiva",
    "overiva_ip2",
    "auxiva_ip2",
    "overiva_iss",
    "auxiva_iss_batch",
    "overiva_iss_batch",
    "overiva_ip2_batch",
    "ogive_batch",
    "five_batch",
    "fastmnmf_batch",
    "fastmnmf2_batch",
    "sparseauxiva_batch",
    "ilrma_batch",
    "auxiva_pca_batch",
    "wpe",
    "wpe_batch",
    "OnlineWPE",
]

DEFAULT_DTYPE = np.complex64


# ---------------------------------------------------------------- boundary

_merge = jax.jit(lambda r, i: r + 1j * i)
_split = jax.jit(lambda c: (jnp.real(c), jnp.imag(c)))


def _ensure(x):
    """np.asarray for host inputs; device arrays pass through untouched
    (no device->host round trip)."""
    return x if isinstance(x, jax.Array) else np.asarray(x)


def _to_device(x, cdtype):
    """Host complex/real ndarray -> device-resident complex array.

    Already-device complex arrays are returned as-is (cast if needed) so
    callers can upload once and fan out over many algorithms — the sweep
    harness's hot path (re-uploading a 60 MB STFT batch per algorithm is
    pure transfer)."""
    if isinstance(x, jax.Array):
        if jnp.iscomplexobj(x):
            return x if x.dtype == cdtype else x.astype(cdtype)
        return x.astype(cdtype)
    re, im = split_np(np.asarray(x), real_dtype_of(cdtype))
    return _merge(jnp.asarray(re), jnp.asarray(im))


def to_device(X, dtype=None):
    """Public: move a (complex or real) array to the device as complex.

    Use to upload a batch STFT once and pass the result to many
    ``*_batch(..., )`` calls; each skips its own host->device transfer."""
    return _to_device(X, np.dtype(dtype or DEFAULT_DTYPE))


def _from_jit(re, im, device):
    """(real, imag) jit outputs -> complex, on device or host."""
    if device:
        return _merge(re, im)
    return merge_np(np.asarray(re), np.asarray(im))


def _to_host(c) -> np.ndarray:
    """Device complex array -> host complex ndarray."""
    re, im = _split(c)
    return merge_np(np.asarray(re), np.asarray(im))


# ----------------------------------------------------------------- jitted

@partial(jax.jit, static_argnames=("n_src", "init_eig", "need_cx", "has_w0"))
def _prepare(X, W0, n_src, init_eig, need_cx, has_w0):
    T, F, M = X.shape
    Cx = _covariance(X) if (need_cx or init_eig) else jnp.zeros((F, M, M), X.dtype)
    W_hat = _core.init_w_hat(
        X, n_src, init_eig, Cx=Cx, W0=W0 if has_w0 else None
    )
    return W_hat, Cx


@partial(jax.jit, static_argnames=("n_src",))
def _snapshot(X, W_hat, n_src):
    """Projection-back-scaled copy of the current estimates (for callbacks)."""
    Y = _core.demix(X, W_hat[:, :n_src, :])
    Y = _proj.apply_projection_back(Y, X[:, :, 0])
    return jnp.real(Y), jnp.imag(Y)


@partial(jax.jit, static_argnames=("n_src", "proj_back"))
def _finalize(X, W_hat, n_src, proj_back):
    Y = _core.demix(X, W_hat[:, :n_src, :])
    if proj_back:
        Y = _proj.apply_projection_back(Y, X[:, :, 0])
    return jnp.real(Y), jnp.imag(Y)


# -------------------------------------------------------------- algorithms

def _overiva_df_host(X, N, n_iter, model, proj_back, W0, return_filters,
                     callback, callback_every, chunk_frames):
    """Host plumbing for the double-float tier (acc="f32x2"): exact f32
    planes in, df epochs on device, c64 out. Mirrors the main path's
    callback chunking."""
    re, im = split_np(X.astype(np.complex64), np.float32)
    xr, xi = jnp.asarray(re), jnp.asarray(im)
    one = np.float32(1.0)
    chunk = int(chunk_frames) if chunk_frames else 16
    if W0 is not None:
        w0 = np.asarray(W0).astype(np.complex64)
        w0r, w0i = (jnp.asarray(p) for p in split_np(w0, np.float32))
    else:
        w0r = w0i = jnp.zeros((0,), jnp.float32)
    W, Cx = _dfcore.prepare_df(xr, xi, w0r, w0i, one, N, W0 is not None)

    def run(W, step):
        return _dfcore.overiva_df_iterations(
            xr, xi, W, Cx, one, N, step, model, chunk=chunk
        )

    if callback is None:
        W = run(W, n_iter)
    else:
        done = 0
        while done < n_iter:
            yr, yi = _dfcore.finalize_df(xr, xi, W, one, N, True)
            callback(merge_np(np.asarray(yr), np.asarray(yi)))
            step = min(callback_every, n_iter - done)
            W = run(W, step)
            done += step

    yr, yi = _dfcore.finalize_df(xr, xi, W, one, N, proj_back)
    Y = merge_np(np.asarray(yr), np.asarray(yi))
    if return_filters:
        wr, wi = _dfcore.df_to_planes(W)
        return Y, merge_np(np.asarray(wr), np.asarray(wi))
    return Y


def _joint_df_host(X, kind, N, taps, delay, n_iter, warm_iter, model,
                   proj_back, W0, return_filters, callback, callback_every):
    """Host plumbing for the joint-family double-float tier (acc="f32x2"):
    exact f32 planes in, df T-ISS/T-IP epochs on device, c64 out
    (models/joint_df.py). Mirrors the oracles' callback cadence."""
    from .models import joint_df as _jdf

    T, F, M = X.shape
    re, im = split_np(X.astype(np.complex64), np.float32)
    xr, xi = jnp.asarray(re), jnp.asarray(im)
    one = np.float32(1.0)
    xtr, xti = _jdf.augment_planes(xr, xi, taps, delay)
    MJ = M + M * taps
    if W0 is not None:
        P0 = np.asarray(
            _to_host(_augmented_w0(W0, F, M, N, taps, np.complex64))
        ).astype(np.complex64)
        p0r, p0i = split_np(P0, np.float32)
        P = _jdf.planes_to_cdf(jnp.asarray(p0r), jnp.asarray(p0i))
        warm = 0
    else:
        P = _jdf.eye_aug_df(F, M, MJ)
        # the warm-up is tap-induced (oracle/tip.py:98); tiss never warms
        warm = int(warm_iter) if (kind == "tip" and taps > 0) else 0
    x0r, x0i = xr[:, :, 0:1], xi[:, :, 0:1]

    if kind == "tiss":
        if callback is None:
            P, Y = _jdf.tiss_df_iterations(
                xtr, xti, P, one, int(n_iter), model, M, N
            )
        else:
            P, Y = _jdf.tiss_df_iterations(xtr, xti, P, one, 0, model, M, N)
            done = 0
            while done < n_iter:
                yr, yi = _jdf.finalize_from_y_df(Y, x0r, x0i, one, N, True)
                callback(merge_np(np.asarray(yr), np.asarray(yi)))
                step = min(callback_every, n_iter - done)
                P, Y = _jdf.tiss_df_iterations(
                    xtr, xti, P, one, step, model, M, N
                )
                done += step
        yr, yi = _jdf.finalize_from_y_df(
            Y, x0r, x0i, one, N, bool(proj_back)
        )
    else:  # tip
        if warm:
            P, _ = _jdf.tiss_df_iterations(
                xtr, xti, P, one, warm, model, M, N
            )
        if callback is None:
            P = _jdf.tip_df_iterations(
                xtr, xti, P, one, int(n_iter), model, M, N
            )
        else:
            done = 0
            while done < n_iter:
                yr, yi = _jdf.finalize_from_p_df(
                    xtr, xti, P, x0r, x0i, one, N, True
                )
                callback(merge_np(np.asarray(yr), np.asarray(yi)))
                step = min(callback_every, n_iter - done)
                P = _jdf.tip_df_iterations(
                    xtr, xti, P, one, step, model, M, N
                )
                done += step
        yr, yi = _jdf.finalize_from_p_df(
            xtr, xti, P, x0r, x0i, one, N, bool(proj_back)
        )
    Y = merge_np(np.asarray(yr), np.asarray(yi))
    if return_filters:
        pr, pi = _jdf.cdf_to_planes(P)
        return Y, merge_np(np.asarray(pr), np.asarray(pi))
    return Y


def _joint_df_guard(acc, dtype, cdtype, wcov=None):
    """Shared acc="f32x2" kwarg validation for the joint family."""
    if str(acc) not in ("f32", "f32x2"):
        raise ValueError(f"acc must be 'f32' or 'f32x2', got {acc!r}")
    if acc != "f32x2":
        return False
    if dtype is not None and cdtype != np.dtype(np.complex64):
        raise ValueError(
            "acc='f32x2' is the double-float-of-complex64 tier; "
            f"dtype={dtype!r} is not combinable with it"
        )
    if wcov is not None and str(wcov) != "f32":
        raise ValueError(
            f"wcov={wcov!r} is not combinable with acc='f32x2' "
            "(the df tier has its own precision)"
        )
    return True


def overiva(
    X,
    n_src=None,
    n_iter=20,
    proj_back=True,
    W0=None,
    model="laplace",
    init_eig=False,
    return_filters=False,
    callback=None,
    callback_every=10,
    dtype=None,
    chunk_frames=None,
    wcov="f32",
    acc="f32",
):
    """OverIVA (AuxIVA when n_src == n_chan). Reference: ``overiva.py``.

    X: (n_frames, n_freq, n_chan) complex ndarray. Returns Y
    (n_frames, n_freq, n_src) ndarray [, W_hat (n_freq, n_chan, n_chan)].

    ``chunk_frames``: stream the weighted-covariance accumulation over frame
    blocks of this size — bounds memory for very long recordings
    (SURVEY.md §5.7) at identical results.

    ``wcov``: weighted-covariance tier (the per-iteration FLOPs majority;
    ops/covariance.py). "f32" (default) is the parity path. "bf16" rounds
    the operands to bfloat16 with float32 accumulation (~1e-3 relative
    error on V); separation quality stays within ~0.05 dB of f32 on clean
    and noisy mixtures at moderate reverb (tests/test_bf16.py), but in
    HEAVY reverb (RIR past the STFT window) a 10-room re-measure showed a
    REAL mean degradation of ~1.5-2.3 dB SIR — do not use bf16 there
    (docs/DESIGN.md §2c). "f32x3" asks for ``lax.Precision.HIGH``, which
    the GPU runs as TF32 (~1e-4 relative error on V). What each tier saves
    on the card: bench/exp_wcov_tiers.py, numbers in PERF.md.

    ``acc="f32x2"``: run the ENTIRE iteration in double-float (emulated
    f64) on the device — the parity tier that closes the gauss-family
    complex64 floor against the f64 oracle on hardware with no native
    float64 (models/overiva_df.py, PARITY.md round-4 experiment).
    ~20x the arithmetic of the f32 path; use for certification, not
    throughput. Not combinable with ``init_eig`` or a non-default
    ``dtype``/``wcov``.
    """
    X = np.asarray(X)
    T, F, M = X.shape
    N = M if n_src is None else int(n_src)
    if not 1 <= N <= M:
        raise ValueError("need 1 <= n_src <= n_chan")
    cdtype = np.dtype(dtype or DEFAULT_DTYPE)
    if str(wcov) not in WCOV_MODES:
        raise ValueError(f"wcov must be one of {WCOV_MODES}, got {wcov!r}")
    if str(acc) not in ("f32", "f32x2"):
        raise ValueError(f"acc must be 'f32' or 'f32x2', got {acc!r}")
    if acc == "f32x2":
        if init_eig:
            raise ValueError("init_eig is not supported with acc='f32x2'")
        if dtype is not None and cdtype != np.dtype(np.complex64):
            raise ValueError(
                "acc='f32x2' is the double-float-of-complex64 tier; "
                f"dtype={dtype!r} is not combinable with it"
            )
        if str(wcov) != "f32":
            raise ValueError(
                f"wcov={wcov!r} is not combinable with acc='f32x2' "
                "(the df tier has its own precision)"
            )
        return _overiva_df_host(
            X, N, int(n_iter), str(model), bool(proj_back), W0,
            bool(return_filters), callback, int(callback_every),
            chunk_frames,
        )

    Xd = _to_device(X, cdtype)
    W0d = _to_device(W0, cdtype) if W0 is not None else Xd[:0]  # placeholder
    W_hat, Cx = _prepare(Xd, W0d, N, bool(init_eig), N < M, W0 is not None)

    chunk = int(chunk_frames) if chunk_frames else None
    if callback is None:
        W_hat = _core.overiva_iterations(
            Xd, W_hat, Cx, N, int(n_iter), model, chunk_frames=chunk,
            wcov=str(wcov),
        )
    else:
        done = 0
        while done < n_iter:
            re, im = _snapshot(Xd, W_hat, N)
            callback(merge_np(np.asarray(re), np.asarray(im)))
            step = min(callback_every, n_iter - done)
            W_hat = _core.overiva_iterations(
                Xd, W_hat, Cx, N, step, model, chunk_frames=chunk,
                wcov=str(wcov),
            )
            done += step

    re, im = _finalize(Xd, W_hat, N, bool(proj_back))
    Y = merge_np(np.asarray(re), np.asarray(im))
    if return_filters:
        return Y, _to_host(W_hat)
    return Y


def overiva_ip2(
    X,
    n_src=None,
    n_iter=20,
    proj_back=True,
    W0=None,
    model="laplace",
    init_eig=False,
    return_filters=False,
    callback=None,
    callback_every=10,
    dtype=None,
    wcov="f32",
):
    """Pairwise-update OverIVA/AuxIVA (IP2): 3-5x faster convergence per
    epoch than IP1 (extension beyond the reference; PAPERS.md:
    arXiv:2003.09531 / Ono 2018 lineage — oracle twin
    ``overiva_jax.oracle.overiva_ip2`` has the derivation and validation).

    Requires n_src >= 2. X: (n_frames, n_freq, n_chan) complex; returns
    Y (n_frames, n_freq, n_src) [, W_hat]. ``wcov="bf16"`` as in
    :func:`overiva`.
    """
    from .models.overiva_ip2 import overiva_ip2_iterations

    X = np.asarray(X)
    T, F, M = X.shape
    N = M if n_src is None else int(n_src)
    if not 2 <= N <= M:
        raise ValueError(f"IP2 needs 2 <= n_src <= n_chan, got {N}")
    cdtype = np.dtype(dtype or DEFAULT_DTYPE)
    if str(wcov) not in WCOV_MODES:
        raise ValueError(f"wcov must be one of {WCOV_MODES}, got {wcov!r}")

    Xd = _to_device(X, cdtype)
    W0d = _to_device(W0, cdtype) if W0 is not None else Xd[:0]
    W_hat, Cx = _prepare(Xd, W0d, N, bool(init_eig), N < M, W0 is not None)

    if callback is None:
        W_hat = overiva_ip2_iterations(
            Xd, W_hat, Cx, N, int(n_iter), model, wcov=str(wcov)
        )
    else:
        done = 0
        while done < n_iter:
            re, im = _snapshot(Xd, W_hat, N)
            callback(merge_np(np.asarray(re), np.asarray(im)))
            step = min(callback_every, n_iter - done)
            W_hat = overiva_ip2_iterations(
                Xd, W_hat, Cx, N, step, model, wcov=str(wcov)
            )
            done += step

    re, im = _finalize(Xd, W_hat, N, bool(proj_back))
    Y = merge_np(np.asarray(re), np.asarray(im))
    if return_filters:
        return Y, _to_host(W_hat)
    return Y


def auxiva_ip2(X, n_src=None, **kw):
    """Determined pairwise AuxIVA (n_src must equal n_chan)."""
    X = np.asarray(X)
    M = X.shape[2]
    N = M if n_src is None else int(n_src)
    if N != M:
        raise ValueError("auxiva_ip2 is determined: n_src must equal n_chan")
    return overiva_ip2(X, n_src=M, **kw)


def auxiva_iss(
    X,
    n_src=None,
    n_iter=20,
    proj_back=True,
    W0=None,
    model="laplace",
    return_filters=False,
    callback=None,
    callback_every=10,
    dtype=None,
):
    """AuxIVA with iterative source steering (rank-1, solve-free updates).

    Extension beyond the reference repo (PAPERS.md: arXiv:2009.09402 /
    Scheibler & Ono 2020). Determined: n_src == n_chan.
    """
    from .models.auxiva_iss import auxiva_iss_iterations

    X = np.asarray(X)
    T, F, M = X.shape
    N = M if n_src is None else int(n_src)
    if N != M:
        raise ValueError("auxiva_iss is determined: n_src must equal n_chan")
    cdtype = np.dtype(dtype or DEFAULT_DTYPE)

    Xd = _to_device(X, cdtype)
    W = _to_device(W0, cdtype) if W0 is not None else _eye_like(Xd, M)

    if callback is None:
        W, Yd = auxiva_iss_iterations(Xd, W, int(n_iter), model)
    else:
        done = 0
        Yd = _demix_jit(Xd, W)
        while done < n_iter:
            re, im = _snapshot_y(Xd, Yd)
            callback(merge_np(np.asarray(re), np.asarray(im)))
            step = min(callback_every, n_iter - done)
            # carry (W, Y) across chunks: ISS maintains Y incrementally
            W, Yd = _iss_chunk(Xd, W, Yd, step, model)
            done += step

    re, im = _finalize_y(Xd, Yd, bool(proj_back))
    Y = merge_np(np.asarray(re), np.asarray(im))
    if return_filters:
        return Y, _to_host(W)
    return Y


def overiva_iss(
    X,
    n_src=None,
    n_iter=20,
    proj_back=True,
    W0=None,
    model="laplace",
    return_filters=False,
    callback=None,
    callback_every=10,
    dtype=None,
):
    """Overdetermined IVA by iterative source steering (rank-1, solve-free).

    Extension beyond the reference repo, derived from the unified
    overdetermined-IVA view (PAPERS.md: arXiv:2003.02458): the M - n_src
    background outputs carry a stationary unit-Gaussian model (phi = 1).
    N == M degenerates exactly to :func:`auxiva_iss`. Oracle twin:
    ``overiva_jax.oracle.overiva_iss``.
    """
    from .models.auxiva_iss import auxiva_iss_iterations

    X = np.asarray(X)
    T, F, M = X.shape
    N = M if n_src is None else int(n_src)
    if not 1 <= N <= M:
        raise ValueError(f"n_src must be in [1, {M}], got {N}")
    cdtype = np.dtype(dtype or DEFAULT_DTYPE)

    Xd = _to_device(X, cdtype)
    if W0 is not None:
        W0 = np.asarray(W0)
        if W0.shape[1] != M:  # (F, N, M) target rows into identity
            full = np.tile(np.eye(M, dtype=W0.dtype), (F, 1, 1))
            full[:, :N, :] = W0
            W0 = full
        W = _to_device(W0, cdtype)
    else:
        W = _eye_like(Xd, M)

    if callback is None:
        W, Yd = auxiva_iss_iterations(Xd, W, int(n_iter), model, n_src=N)
    else:
        done = 0
        Yd = _demix_jit(Xd, W)
        while done < n_iter:
            re, im = _snapshot_y(Xd, _take_srcs(Yd, N))
            callback(merge_np(np.asarray(re), np.asarray(im)))
            step = min(callback_every, n_iter - done)
            W, Yd = _iss_chunk(Xd, W, Yd, step, model, N)
            done += step

    re, im = _finalize_y(Xd, _take_srcs(Yd, N), bool(proj_back))
    Y = merge_np(np.asarray(re), np.asarray(im))
    if return_filters:
        return Y, _to_host(W)
    return Y


@partial(jax.jit, static_argnames=("taps", "delay"))
def _tiss_augment(X, taps, delay):
    from .models.tiss import augment_taps

    return augment_taps(X, taps, delay)


@partial(jax.jit, static_argnames=("n_chan",))
def _tiss_eye(Xt, n_chan):
    from .models.tiss import augmented_eye

    return augmented_eye(Xt, n_chan)


def _augmented_w0(W0, F, M, N, taps, cdtype):
    """User W0 -> device (F, M, M + M*taps) augmented stack (shared by the
    joint-dereverb entry points). Accepts a previous full augmented P, a
    square (F, M, M) stack (zero tap block), or (F, N, M) target rows
    (placed into identity). Dispatch on the ROW count first: at taps=0
    the full-augmented and square widths coincide, and testing width
    first misrouted (F, N, M) target rows into the full branch."""
    W0h = _to_host(W0) if isinstance(W0, jax.Array) else np.asarray(W0)
    if W0h.shape[1] != M:  # (F, N, M) target rows into identity
        P0 = np.zeros((F, M, M + M * taps), W0h.dtype)
        P0[:, :, :M] = np.eye(M)
        P0[:, :N, :M] = W0h
    elif W0h.shape[2] == M + M * taps:  # full augmented (== square at taps=0)
        P0 = W0h.copy()
    else:  # square (F, M, M), zero tap block
        P0 = np.zeros((F, M, M + M * taps), W0h.dtype)
        P0[:, :, :M] = W0h
    return _to_device(P0, cdtype)


@partial(jax.jit, static_argnames=("n_iter", "model", "n_chan", "n_src"))
def _tiss_chunk(Xt, P, Y, n_iter, model, n_chan, n_src):
    from .models.tiss import _tiss_epoch

    P, Y = jax.lax.fori_loop(
        0,
        n_iter,
        lambda _, s: _tiss_epoch(Xt, s, model, n_chan, n_src=n_src),
        (P, Y),
    )
    return P, Y


def tiss(
    X,
    n_src=None,
    taps=5,
    delay=2,
    n_iter=20,
    proj_back=True,
    W0=None,
    model="laplace",
    return_filters=False,
    callback=None,
    callback_every=10,
    dtype=None,
    acc="f32",
):
    """JOINT dereverberation + separation by iterative source steering
    (T-ISS). Extension beyond the reference repo (PAPERS.md lineage:
    arXiv:2009.09402 ISS; Nakashima, Scheibler, Togami & Ono, ICASSP 2021).
    Oracle twin ``overiva_jax.oracle.tiss`` has the derivation.

    The demixing operates on ``[X | taps delayed copies]`` so the returned
    sources are separated AND dereverberated in one optimization — the
    principled alternative to the WPE -> IVA cascade (same aux function,
    rank-1 solve-free updates only). ``taps=0`` degenerates exactly to
    :func:`auxiva_iss` / :func:`overiva_iss`; ``n_src < n_chan`` uses the
    stationary-background OverIVA-ISS view. ``delay >= 1`` keeps the direct
    path out of the predictor; use ``delay >= 2`` under 50% frame overlap
    (same operating-point guidance as :func:`wpe` — docs/DESIGN.md §7).

    W0 may be a previous full (F, M, M + M*taps) stack, a square (F, M, M)
    stack, or (F, n_src, M) target rows.

    ``acc="f32x2"``: run the ENTIRE iteration in double-float (emulated
    f64) on the device — the certification tier extended to the joint
    family (models/joint_df.py). ~20x the arithmetic
    of the f32 path; use for hardware certification against the f64
    oracle, not throughput.
    """
    from .models.tiss import tiss_iterations

    X = _ensure(X)
    T, F, M = X.shape
    N = M if n_src is None else int(n_src)
    if not 1 <= N <= M:
        raise ValueError(f"n_src must be in [1, {M}], got {N}")
    taps, delay = int(taps), int(delay)
    if taps < 0 or (taps > 0 and delay < 1):
        raise ValueError("need taps >= 0 and delay >= 1 when taps > 0")
    cdtype = np.dtype(dtype or DEFAULT_DTYPE)
    if _joint_df_guard(acc, dtype, cdtype):
        return _joint_df_host(
            np.asarray(X), "tiss", N, taps, delay, int(n_iter), 0,
            str(model), bool(proj_back), W0, bool(return_filters),
            callback, int(callback_every),
        )

    Xd = _to_device(X, cdtype)
    Xt = _tiss_augment(Xd, taps, delay)
    if W0 is not None:
        P = _augmented_w0(W0, F, M, N, taps, cdtype)
    else:
        P = _tiss_eye(Xt, M)

    if callback is None:
        P, Yd = tiss_iterations(Xt, P, int(n_iter), model, M, n_src=N)
    else:
        done = 0
        Yd = _demix_jit(Xt, P)
        while done < n_iter:
            re, im = _snapshot_y(Xd, _take_srcs(Yd, N))
            callback(merge_np(np.asarray(re), np.asarray(im)))
            step = min(callback_every, n_iter - done)
            P, Yd = _tiss_chunk(Xt, P, Yd, step, model, M, N)
            done += step

    re, im = _finalize_y(Xd, _take_srcs(Yd, N), bool(proj_back))
    Y = merge_np(np.asarray(re), np.asarray(im))
    if return_filters:
        return Y, _to_host(P)
    return Y


@partial(
    jax.jit, static_argnames=("n_iter", "model", "n_chan", "n_src", "wcov")
)
def _tip_chunk(Xt, P, n_iter, model, n_chan, n_src, wcov="f32"):
    from .models.tip import _background_pieces, _tip_epoch

    # same run-constant background hoist as tip_iterations: recomputed
    # per chunk (cheap — one covariance) instead of per EPOCH
    N = n_chan if n_src is None else n_src
    bg = _background_pieces(Xt, n_chan, wcov) if N < n_chan else None
    return jax.lax.fori_loop(
        0,
        n_iter,
        lambda _, p: _tip_epoch(Xt, p, model, n_chan, n_src=n_src, wcov=wcov,
                                bg=bg),
        P,
    )


def tip(
    X,
    n_src=None,
    taps=5,
    delay=2,
    n_iter=10,
    warm_iter=10,
    proj_back=True,
    W0=None,
    model="laplace",
    return_filters=False,
    callback=None,
    callback_every=10,
    dtype=None,
    wcov="f32",
    acc="f32",
):
    """T-IP: joint dereverberation + separation with EXACT iterative-
    projection row updates on the augmented input (the solve-based sibling
    of :func:`tiss`; the T-ISS paper's "ILRMA-T-IP"-style baseline).
    Oracle twin ``overiva_jax.oracle.tip`` has the derivation and the
    measured warm-start requirement: when no ``W0`` is given and
    ``taps > 0``, ``warm_iter`` T-ISS epochs run first inside the same
    program (cold-start full-row solves collapse on some scenes). Each
    T-IP epoch is ~MJ^3/M^2-fold costlier than a T-ISS epoch (MJ-dim
    solves) but exactly minimizes the surrogate per row — measured best
    as a short polish after the rank-1 warm-up, with ``model="gauss"``
    the stronger polish on the hard-room probe (docs/DESIGN.md §8).

    ``taps=0, n_src=M`` degenerates exactly to :func:`auxiva` (cold
    start — the warm-up is skipped at taps=0). ``wcov`` selects the
    MJ-dim weighted-covariance tier ("f32" exact / "f32x3" / "bf16"
    reduced-precision modes — ops/covariance.py; T-IP's covariance is
    MJ-sized, so the tiers bite harder here than on the M<=8 IVA wcov).

    ``acc="f32x2"``: the ENTIRE pipeline (warm-up T-ISS epochs included)
    in double-float on device, mirroring the oracle's DENSE MJ-dim solve
    rather than the Schur reduction — the certification tier for the
    joint family (models/joint_df.py). Certification
    only; ~20x the f32 arithmetic.
    """
    from .models.tip import tip_iterations
    from .models.tiss import tiss_iterations

    X = _ensure(X)
    T, F, M = X.shape
    N = M if n_src is None else int(n_src)
    if not 1 <= N <= M:
        raise ValueError(f"n_src must be in [1, {M}], got {N}")
    taps, delay = int(taps), int(delay)
    if taps < 0 or (taps > 0 and delay < 1):
        raise ValueError("need taps >= 0 and delay >= 1 when taps > 0")
    if str(wcov) not in WCOV_MODES:
        raise ValueError(f"wcov must be one of {WCOV_MODES}, got {wcov!r}")
    cdtype = np.dtype(dtype or DEFAULT_DTYPE)
    if _joint_df_guard(acc, dtype, cdtype, wcov=wcov):
        return _joint_df_host(
            np.asarray(X), "tip", N, taps, delay, int(n_iter),
            int(warm_iter), str(model), bool(proj_back), W0,
            bool(return_filters), callback, int(callback_every),
        )

    Xd = _to_device(X, cdtype)
    Xt = _tiss_augment(Xd, taps, delay)
    if W0 is not None:
        P = _augmented_w0(W0, F, M, N, taps, cdtype)
    else:
        P = _tiss_eye(Xt, M)
        if warm_iter > 0 and taps > 0:
            P, _ = tiss_iterations(Xt, P, int(warm_iter), model, M, n_src=N)

    if callback is None:
        P = tip_iterations(
            Xt, P, int(n_iter), model, M, n_src=N, wcov=str(wcov)
        )
    else:
        done = 0
        while done < n_iter:
            Yd = _demix_jit(Xt, P)
            re, im = _snapshot_y(Xd, _take_srcs(Yd, N))
            callback(merge_np(np.asarray(re), np.asarray(im)))
            step = min(callback_every, n_iter - done)
            P = _tip_chunk(Xt, P, step, model, M, N, str(wcov))
            done += step

    Yd = _demix_jit(Xt, P)
    re, im = _finalize_y(Xd, _take_srcs(Yd, N), bool(proj_back))
    Y = merge_np(np.asarray(re), np.asarray(im))
    if return_filters:
        return Y, _to_host(P)
    return Y


@partial(jax.jit, static_argnames=("n_iter", "n_chan"))
def _ilrma_t_chunk(Xt, P, Y, B, H, n_iter, n_chan):
    from .models.ilrma_t import _ilrma_t_epoch

    return jax.lax.fori_loop(
        0,
        n_iter,
        lambda _, s: _ilrma_t_epoch(Xt, s, n_chan),
        (P, Y, B, H),
    )


def ilrma_t(
    X,
    n_src=None,
    taps=5,
    delay=2,
    n_iter=20,
    proj_back=True,
    W0=None,
    n_components=2,
    return_filters=False,
    callback=None,
    callback_every=10,
    seed=0,
    dtype=None,
):
    """ILRMA-T: JOINT dereverberation + ILRMA (NMF source model driving
    T-ISS rank-1 steering on ``[X | delayed taps]``). Extension beyond the
    reference repo; oracle twin ``overiva_jax.oracle.ilrma_t`` has the
    derivation and validation anchors. Determined (n_src == n_chan);
    ``taps=0`` gives ILRMA-ISS (same model as :func:`ilrma`, solve-free
    optimizer, different trajectory). NMF init matches the oracle: one
    ``default_rng(seed).random`` draw each for basis and activations.
    """
    from .models.ilrma_t import ilrma_t_iterations

    X = _ensure(X)
    T, F, M = X.shape
    N = M if n_src is None else int(n_src)
    if N != M:
        raise ValueError("ilrma_t is determined: n_src must equal n_chan")
    taps, delay = int(taps), int(delay)
    if taps < 0 or (taps > 0 and delay < 1):
        raise ValueError("need taps >= 0 and delay >= 1 when taps > 0")
    cdtype = np.dtype(dtype or DEFAULT_DTYPE)
    rdtype = real_dtype_of(cdtype)

    rng = np.random.default_rng(seed)
    B = (rng.random((M, F, n_components)) + 0.1).astype(rdtype)
    H = (rng.random((M, n_components, T)) + 0.1).astype(rdtype)

    Xd = _to_device(X, cdtype)
    Xt = _tiss_augment(Xd, taps, delay)
    if W0 is not None:
        P = _augmented_w0(W0, F, M, N, taps, cdtype)
    else:
        P = _tiss_eye(Xt, M)

    Bd, Hd = jnp.asarray(B), jnp.asarray(H)
    if callback is None:
        P, Yd, Bd, Hd = ilrma_t_iterations(Xt, P, Bd, Hd, int(n_iter), M)
    else:
        done = 0
        Yd = _demix_jit(Xt, P)
        while done < n_iter:
            re, im = _snapshot_y(Xd, Yd)
            callback(merge_np(np.asarray(re), np.asarray(im)))
            step = min(callback_every, n_iter - done)
            P, Yd, Bd, Hd = _ilrma_t_chunk(Xt, P, Yd, Bd, Hd, step, M)
            done += step

    re, im = _finalize_y(Xd, Yd, bool(proj_back))
    Y = merge_np(np.asarray(re), np.asarray(im))
    if return_filters:
        return Y, _to_host(P)
    return Y


@partial(jax.jit, static_argnames=("n",))
def _take_srcs(Y, n):
    return Y[:, :, :n]


@jax.jit
def _demix_jit(X, W):
    from .models.overiva import demix

    return demix(X, W)


@partial(jax.jit, static_argnames=("n_iter", "model", "n_src"))
def _iss_chunk(X, W, Y, n_iter, model, n_src=None):
    from .models.auxiva_iss import _iss_epoch

    W, Y = jax.lax.fori_loop(
        0,
        n_iter,
        lambda _, s: _iss_epoch(X, s, model, n_src=n_src),
        (W, Y),
    )
    return W, Y


@jax.jit
def _snapshot_y(X, Y):
    Yp = _proj.apply_projection_back(Y, X[:, :, 0])
    return jnp.real(Yp), jnp.imag(Yp)


@partial(jax.jit, static_argnames=("proj_back",))
def _finalize_y(X, Y, proj_back):
    if proj_back:
        Y = _proj.apply_projection_back(Y, X[:, :, 0])
    return jnp.real(Y), jnp.imag(Y)


def auxiva(
    X,
    n_src=None,
    n_iter=20,
    proj_back=True,
    W0=None,
    model="laplace",
    return_filters=False,
    callback=None,
    callback_every=10,
    dtype=None,
    wcov="f32",
    acc="f32",
):
    """Determined AuxIVA. Reference: ``pyroomacoustics.bss.auxiva``."""
    X = np.asarray(X)
    M = X.shape[2]
    N = M if n_src is None else int(n_src)
    if N != M:
        raise ValueError("auxiva is determined: n_src must equal n_chan")
    return overiva(
        X,
        n_src=N,
        n_iter=n_iter,
        proj_back=proj_back,
        W0=W0,
        model=model,
        init_eig=False,
        return_filters=return_filters,
        callback=callback,
        callback_every=callback_every,
        dtype=dtype,
        wcov=wcov,
        acc=acc,
    )


@partial(jax.jit, static_argnames=("n_src", "return_basis"))
def _pca_jit(X, n_src, return_basis):
    out = _pca_mod.pca(X, n_src, return_basis)
    if return_basis:
        Xr, E = out
        return jnp.real(Xr), jnp.imag(Xr), jnp.real(E), jnp.imag(E)
    return jnp.real(out), jnp.imag(out)


def pca(X, n_src, return_basis=False, dtype=None):
    """Per-bin principal-subspace reduction. Reference: ``auxiva_pca.pca``."""
    cdtype = np.dtype(dtype or DEFAULT_DTYPE)
    Xd = _to_device(np.asarray(X), cdtype)
    if return_basis:
        rr, ri, er, ei = _pca_jit(Xd, int(n_src), True)
        return merge_np(np.asarray(rr), np.asarray(ri)), merge_np(
            np.asarray(er), np.asarray(ei)
        )
    rr, ri = _pca_jit(Xd, int(n_src), False)
    return merge_np(np.asarray(rr), np.asarray(ri))


def auxiva_pca(
    X,
    n_src=None,
    n_iter=20,
    proj_back=True,
    model="laplace",
    return_filters=False,
    callback=None,
    callback_every=10,
    dtype=None,
    inner="ip",
):
    """PCA to n_src dims then determined AuxIVA; projection back against the
    ORIGINAL mic 0. Reference: ``auxiva_pca.py``.

    ``inner``: "ip" (reference-matching iterative projection), "iss"
    (rank-1 source steering — the fast overdetermined path: one eigh
    + solve-free iterations), or "ip2" (pairwise joint updates — fewest
    iterations to converge; needs n_src >= 2)."""
    X = np.asarray(X)
    T, F, M = X.shape
    N = M if n_src is None else int(n_src)
    if inner == "ip2" and N < 2:
        raise ValueError("inner='ip2' needs n_src >= 2")
    X_r = pca(X, N, dtype=dtype) if N < M else X

    inner_fn = {"ip": auxiva, "iss": auxiva_iss, "ip2": auxiva_ip2}[inner]
    res = inner_fn(
        X_r,
        n_src=N,
        n_iter=n_iter,
        proj_back=False,
        model=model,
        return_filters=return_filters,
        callback=callback,
        callback_every=callback_every,
        dtype=dtype,
    )
    Y, W = res if return_filters else (res, None)

    if proj_back:
        z = projection_back(Y, X[:, :, 0])
        Y = Y * np.conj(z)[None, :, :]
    if return_filters:
        return Y, W
    return Y


def ogive(
    X,
    n_iter=4000,
    step_size=0.1,
    tol=1e-3,
    update="demix",
    proj_back=True,
    model="laplace",
    init_eig=False,
    return_filters=False,
    callback=None,
    callback_every=100,
    switch_every=10,
    dtype=None,
):
    """OGIVE single-source extraction. Reference: ``ive.py``.

    Returns Y (n_frames, n_freq, 1) [, w (n_freq, n_chan)].
    """
    if update not in ("demix", "mix", "switching"):
        raise ValueError(f"unknown update mode {update!r}")
    X = np.asarray(X)
    cdtype = np.dtype(dtype or DEFAULT_DTYPE)
    rdtype = real_dtype_of(cdtype)
    Xd = _to_device(X, cdtype)

    w, a, Cx, Cx_inv = _ogive_init_jit(Xd, bool(init_eig))
    use_mix = jnp.zeros((X.shape[1],), bool)
    mu = jnp.asarray(step_size, rdtype)
    tolj = jnp.asarray(tol, rdtype)

    epoch = jnp.asarray(0, jnp.int32)
    if callback is None:
        w, a, use_mix, epoch, done = _ogive_mod.ogive_iterations(
            Xd, w, a, use_mix, Cx, Cx_inv, epoch, mu, tolj,
            int(n_iter), model, update, int(switch_every),
        )
    else:
        remaining = int(n_iter)
        while remaining > 0:
            re, im = _ogive_snapshot(Xd, w)
            callback(merge_np(np.asarray(re), np.asarray(im)))
            step = min(int(callback_every), remaining)
            w, a, use_mix, epoch, done = _ogive_mod.ogive_iterations(
                Xd, w, a, use_mix, Cx, Cx_inv, epoch, mu, tolj,
                step, model, update, int(switch_every),
            )
            remaining -= step
            if bool(np.asarray(done)):
                break

    re, im = _ogive_finalize(Xd, w, bool(proj_back))
    Y = merge_np(np.asarray(re), np.asarray(im))
    if return_filters:
        return Y, _to_host(w)
    return Y


@partial(jax.jit, static_argnames=("init_eig",))
def _ogive_init_jit(X, init_eig):
    return _ogive_mod.ogive_init(X, init_eig)


@jax.jit
def _ogive_snapshot(X, w):
    Y = _ogive_mod.ogive_demix(X, w)[:, :, None]
    Y = _proj.apply_projection_back(Y, X[:, :, 0])
    return jnp.real(Y), jnp.imag(Y)


@partial(jax.jit, static_argnames=("proj_back",))
def _ogive_finalize(X, w, proj_back):
    Y = _ogive_mod.ogive_demix(X, w)[:, :, None]
    if proj_back:
        Y = _proj.apply_projection_back(Y, X[:, :, 0])
    return jnp.real(Y), jnp.imag(Y)


def five(
    X,
    n_iter=10,
    proj_back=True,
    model="laplace",
    return_filters=False,
    callback=None,
    callback_every=1,
    dtype=None,
):
    """FIVE: fast single-source extraction by iterative SINR maximization
    (extension beyond the reference; converges in a handful of iterations
    where ogive needs thousands). Returns Y (n_frames, n_freq, 1) [, w]."""
    from .models.five import five_demix, five_iterations, five_whiten

    X = np.asarray(X)
    cdtype = np.dtype(dtype or DEFAULT_DTYPE)
    Xd = _to_device(X, cdtype)
    Xw, Q = _five_whiten_jit(Xd)
    w = _five_init(Xw)

    if callback is None:
        w = five_iterations(Xw, w, int(n_iter), model)
    else:
        done = 0
        while done < n_iter:
            re, im = _five_snapshot(Xd, Xw, w)
            callback(merge_np(np.asarray(re), np.asarray(im)))
            step = min(int(callback_every), n_iter - done)
            w = five_iterations(Xw, w, step, model)
            done += step

    re, im = _five_finalize(Xd, Xw, w, bool(proj_back))
    Y = merge_np(np.asarray(re), np.asarray(im))
    if return_filters:
        w_un = _five_unwhiten(Q, w)
        return Y, _to_host(w_un)
    return Y


@jax.jit
def _five_whiten_jit(X):
    from .models.five import five_whiten

    return five_whiten(X)


@jax.jit
def _five_init(Xw):
    F, M = Xw.shape[1], Xw.shape[2]
    return jnp.zeros((F, M), Xw.dtype).at[:, 0].set(1.0)


@jax.jit
def _five_snapshot(X, Xw, w):
    from .models.five import five_demix

    Y = five_demix(Xw, w)[:, :, None]
    Y = _proj.apply_projection_back(Y, X[:, :, 0])
    return jnp.real(Y), jnp.imag(Y)


@partial(jax.jit, static_argnames=("proj_back",))
def _five_finalize(X, Xw, w, proj_back):
    from .models.five import five_demix

    Y = five_demix(Xw, w)[:, :, None]
    if proj_back:
        Y = _proj.apply_projection_back(Y, X[:, :, 0])
    return jnp.real(Y), jnp.imag(Y)


@jax.jit
def _five_unwhiten(Q, w):
    from .ops.linalg import mat_h

    return jnp.einsum("fmn,fn->fm", mat_h(Q), w)


class _StreamingState:
    """Checkpoint/resume for the streaming classes (SURVEY.md §5.4
    analog of the batch (return_filters, W0) pair): device state crosses
    the host boundary through the complex-safe real/imag split."""

    def save(self, path, **meta):
        """Persist the full streaming state + metadata to ``path`` (npz).
        Returns the written path."""
        from .utils.checkpoint import save_state

        host = {
            k: (_to_host(v) if jnp.iscomplexobj(v) else np.asarray(v))
            for k, v in self.state.items()
        }
        meta.setdefault("class", type(self).__name__)
        return save_state(path, host, **meta)

    def restore(self, path) -> dict:
        """Load state saved by :meth:`save` into this instance (shapes
        must match the constructor configuration). Returns the metadata."""
        from .utils.checkpoint import load_state

        host, meta = load_state(path)
        if set(host) != set(self.state):
            raise ValueError(
                f"checkpoint keys {sorted(host)} != state keys "
                f"{sorted(self.state)}"
            )
        new = {}
        for k, cur in self.state.items():
            h = host[k]
            if tuple(h.shape) != tuple(cur.shape):
                raise ValueError(
                    f"state {k!r}: checkpoint shape {h.shape} != "
                    f"configured {tuple(cur.shape)}"
                )
            if jnp.iscomplexobj(cur):
                new[k] = _to_device(h, np.dtype(cur.dtype))
            else:
                new[k] = jnp.asarray(np.asarray(h, np.dtype(cur.dtype)))
        self.state = new
        return meta


class OnlineAuxIVAISS(_StreamingState):
    """Streaming determined separation: feed STFT blocks, get separated
    blocks with O(block) latency (online rank-1 source steering with
    exponential forgetting; extension beyond the reference — PAPERS.md:
    arXiv:2209.00937 lineage).

    >>> sep = OnlineAuxIVAISS(n_freq=513, n_chan=4, forget=0.97)
    >>> for X_blk in stream:          # (block_frames, n_freq, n_chan) complex
    ...     y_blk = sep.process(X_blk)

    State lives on device; blocks must share the same shape (one compile).

    ``ramp``: forgetting-factor scheduling (RLS-style warm-up: growing
    uniform window, then exponential forgetting). Measured NEUTRAL-to-
    negative on stationary scenes — the zero-initialized statistics
    already act as a growing window — so it defaults off; see
    ``models.online_iss.online_iss_step`` for the A/B numbers.
    ``pb_forget``: separate forgetting for the projection-back scale
    statistics (closer to 1 smooths the per-block output scale without
    slowing demixing adaptation; 0.9995 measured mildly positive).
    """

    def __init__(self, n_freq, n_chan, forget=0.97, model="laplace",
                 n_pass=1, ramp=False, pb_forget=None, dtype=None):
        from .models.online_iss import online_iss_init

        self.model = model
        self.n_pass = int(n_pass)
        self.ramp = bool(ramp)
        cdtype = np.dtype(dtype or DEFAULT_DTYPE)
        self._rdtype = real_dtype_of(cdtype)
        jdtype = jnp.complex64 if cdtype == np.complex64 else jnp.complex128
        self.state = online_iss_init(int(n_freq), int(n_chan), jdtype)
        self.forget = jnp.asarray(forget, self._rdtype)
        self.pb_forget = (
            None if pb_forget is None else jnp.asarray(pb_forget, self._rdtype)
        )
        self._cdtype = cdtype

    def process(self, X_blk) -> np.ndarray:
        """X_blk: (block_frames, n_freq, n_chan) complex ndarray ->
        separated (block_frames, n_freq, n_chan) ndarray."""
        from .models.online_iss import online_iss_step

        Xd = _to_device(np.asarray(X_blk), self._cdtype)
        Y, self.state = online_iss_step(
            Xd, self.state, self.forget, self.model, self.n_pass,
            ramp=self.ramp, pb_forget=self.pb_forget,
        )
        re, im = _split(Y)
        return merge_np(np.asarray(re), np.asarray(im))

    @property
    def filters(self) -> np.ndarray:
        """Current demixing matrix (n_freq, n_chan, n_chan) ndarray."""
        return _to_host(self.state["W"])


class OnlineTISS(_StreamingState):
    """Streaming JOINT dereverberation + separation (online T-ISS):
    feed STFT blocks, get separated AND dereverberated blocks with
    O(block) latency. The dereverberation taps live inside the one
    demixing optimization on ``[X | delayed taps]``, so — unlike the
    OnlineWPE -> OnlineAuxIVAISS cascade, which was measured NEGATIVE
    (the per-block WPE re-solve keeps the effective channel time-varying
    under the downstream tracker) — there is no moving target between
    the two adaptive stages.

    Measured (3-seed reverberant 2x2 streaming scene, RT60 0.35,
    nfft 512, last-4s SIR): plain OnlineAuxIVAISS 4.6/7.4/1.3 dB,
    OnlineWPE cascade 1.8/3.0/1.6, THIS class (taps=4, defaults)
    3.2/7.8/2.8 — i.e. joint streaming dereverberation WITHOUT the
    cascade's 2-4 dB separation penalty (better than plain on 2/3
    seeds; the outputs are additionally dereverberated, which the
    wet-reference SIR does not credit). taps=6 and a longer
    ``tap_forget`` measured neutral-to-slightly-worse; ``tap_update=
    "steer"`` (the literal online analog of the batch tap steps)
    measured clearly worse — see ``models/online_tiss.py`` for why.

    >>> sep = OnlineTISS(n_freq=257, n_chan=2, taps=4, delay=2)
    >>> for X_blk in stream:          # (block_frames, n_freq, n_chan)
    ...     y_blk = sep.process(X_blk)

    State lives on device; blocks must share one shape (one compile).
    ``taps=0`` reproduces :class:`OnlineAuxIVAISS` exactly (tested).
    """

    def __init__(self, n_freq, n_chan, taps=4, delay=2, forget=0.97,
                 model="laplace", n_pass=1, pb_forget=None,
                 tap_update="solve", tap_forget=None, dtype=None):
        from .models.online_tiss import online_tiss_init

        if taps < 0 or (taps > 0 and delay < 1):
            raise ValueError("need taps >= 0 and delay >= 1 when taps > 0")
        if tap_update not in ("solve", "steer"):
            raise ValueError("tap_update must be 'solve' or 'steer'")
        self.model = model
        self.n_pass = int(n_pass)
        self.taps, self.delay = int(taps), int(delay)
        self.tap_update = tap_update
        cdtype = np.dtype(dtype or DEFAULT_DTYPE)
        self._rdtype = real_dtype_of(cdtype)
        jdtype = jnp.complex64 if cdtype == np.complex64 else jnp.complex128
        self.state = online_tiss_init(
            int(n_freq), int(n_chan), self.taps, self.delay, tap_update,
            jdtype,
        )
        self.forget = jnp.asarray(forget, self._rdtype)
        self.pb_forget = (
            None if pb_forget is None else jnp.asarray(pb_forget, self._rdtype)
        )
        self.tap_forget = (
            None if tap_forget is None
            else jnp.asarray(tap_forget, self._rdtype)
        )
        self._cdtype = cdtype

    def process(self, X_blk) -> np.ndarray:
        """X_blk: (block_frames, n_freq, n_chan) complex ndarray ->
        separated+dereverbed (block_frames, n_freq, n_chan) ndarray."""
        from .models.online_tiss import online_tiss_step

        Xd = _to_device(np.asarray(X_blk), self._cdtype)
        Y, self.state = online_tiss_step(
            Xd, self.state, self.forget, self.taps, self.delay, self.model,
            self.n_pass, pb_forget=self.pb_forget,
            tap_update=self.tap_update, tap_forget=self.tap_forget,
        )
        re, im = _split(Y)
        return merge_np(np.asarray(re), np.asarray(im))

    @property
    def filters(self) -> np.ndarray:
        """Current augmented demixing stack (n_freq, M, M + M*taps)."""
        return _to_host(self.state["P"])


class OnlineWPE(_StreamingState):
    """Streaming WPE dereverberation: feed STFT blocks, get dereverbed
    blocks with O(block) latency (recursive tap statistics with
    exponential forgetting, re-solved filter per block — the streaming
    twin of :func:`wpe`; pairs with :class:`OnlineAuxIVAISS` for a fully
    streaming dereverb + separate stack).

    >>> drv = OnlineWPE(n_freq=513, n_chan=4, taps=8, delay=2)
    >>> sep = OnlineAuxIVAISS(n_freq=513, n_chan=4)
    >>> for X_blk in stream:          # (block_frames, n_freq, n_chan)
    ...     y_blk = sep.process(drv.process(X_blk))

    State lives on device; blocks must share one shape (one compile).
    ``forget`` is per frame (effective memory 1/(1-forget) frames).

    Cascade caveat (measured, docs/DESIGN.md §7): feeding this front
    into the online EW separator was NEGATIVE on the determined 2x2
    test scene — the per-block filter re-solve keeps the effective
    channel time-varying and the downstream tracker chases it. The
    streaming dereverb itself converges (tested vs the batch solve);
    for dereverb + separation check quality on your scene, or use the
    batch/fused ``separate(wpe=...)`` path in the regimes the
    matched-arm sweep says it pays (data/waspaa_rt04_wpe/).
    """

    def __init__(self, n_freq, n_chan, taps=8, delay=2, forget=0.99,
                 diag_load=1e-5, dtype=None):
        from .models.online_wpe import online_wpe_init

        if taps < 1:
            raise ValueError("taps must be >= 1")
        if delay < 1:
            raise ValueError("delay must be >= 1 (delay 0 would predict "
                             "the current frame from itself)")
        cdtype = np.dtype(dtype or DEFAULT_DTYPE)
        self._rdtype = real_dtype_of(cdtype)
        self._cdtype = cdtype
        jdtype = jnp.complex64 if cdtype == np.complex64 else jnp.complex128
        self.taps, self.delay = int(taps), int(delay)
        self.diag_load = float(diag_load)
        self.state = online_wpe_init(
            int(n_freq), int(n_chan), self.taps, self.delay, jdtype
        )
        self.forget = jnp.asarray(forget, self._rdtype)

    def process(self, X_blk) -> np.ndarray:
        """X_blk: (block_frames, n_freq, n_chan) complex ndarray ->
        dereverbed block of the same shape."""
        from .models.online_wpe import online_wpe_step

        Xd = _to_device(_ensure(X_blk), self._cdtype)
        Y, self.state = online_wpe_step(
            Xd, self.state, self.forget, self.taps, self.delay,
            self.diag_load,
        )
        re, im = _split(Y)
        return merge_np(np.asarray(re), np.asarray(im))

    @property
    def filters(self) -> np.ndarray:
        """Current prediction filter (n_freq, n_chan*taps, n_chan)."""
        return _to_host(self.state["G"])


# ----------------------------------------------------------------- frontend

def projection_back(Y, ref):
    """Minimal-distortion rescale factors z (host NumPy; tiny op).

    Reference: ``pyroomacoustics.bss.common.projection_back``. The caller
    applies ``Y *= conj(z)[None]`` — same convention as the reference.
    """
    from .oracle.projection import projection_back as _pb

    return _pb(np.asarray(Y), np.asarray(ref))


def stft_analysis(x, nfft, hop=None, win=None, dtype=None, device=False):
    """Time signal (n_samples[, M]) -> complex STFT (T, nfft//2+1[, M]).

    ``device=True`` keeps the result on device (feed it straight into the
    separation APIs without a host round trip)."""
    hop = hop or nfft // 2
    x = np.asarray(x)
    rdtype = real_dtype_of(np.dtype(dtype or DEFAULT_DTYPE))
    re, im = _stft_analysis_jit(jnp.asarray(x.astype(rdtype)), int(nfft), int(hop))
    return _from_jit(re, im, device)


def stft_analysis_batch(x, nfft, hop=None, dtype=None, device=False):
    """Batch of time signals (B, n_samples, M) -> (B, T, nfft//2+1, M).

    One upload of the real mixture batch (half the bytes of the complex
    STFT), one fused device FFT over the whole batch. With ``device=True``
    the batch STFT never touches the host — the sweep harness's input path.
    """
    hop = hop or nfft // 2
    x = np.asarray(x)
    rdtype = real_dtype_of(np.dtype(dtype or DEFAULT_DTYPE))
    re, im = _stft_analysis_batch_jit(
        jnp.asarray(x.astype(rdtype)), int(nfft), int(hop)
    )
    return _from_jit(re, im, device)


def stft_synthesis(X, nfft, hop=None, win_s=None, dtype=None):
    """Complex STFT -> time signal via weighted overlap-add.

    Accepts host arrays or device arrays (e.g. a ``device=True`` separation
    result — no re-upload). ``win_s`` overrides the biorthogonal dual
    synthesis window (default: computed for perfect reconstruction)."""
    hop = hop or nfft // 2
    cdtype = np.dtype(dtype or DEFAULT_DTYPE)
    Xd = _to_device(_ensure(X), cdtype)
    if win_s is None:
        y = _stft_synthesis_jit(Xd, int(nfft), int(hop))
    else:
        w = jnp.asarray(np.asarray(win_s), real_dtype_of(cdtype))
        y = _stft_synthesis_win_jit(Xd, w, int(nfft), int(hop))
    return np.asarray(y)


def stft_synthesis_batch(X, nfft, hop=None, win_s=None, dtype=None):
    """Batch of STFTs (B, T, nfft//2+1, N) -> (B, n_samples, N).

    One fused device overlap-add and ONE host transfer for the whole
    batch — the sweep harness's output path (per-lane :func:`stft_synthesis`
    pays a dispatch + host transfer each). Accepts host or device arrays.
    """
    hop = hop or nfft // 2
    cdtype = np.dtype(dtype or DEFAULT_DTYPE)
    Xd = _to_device(_ensure(X), cdtype)
    if Xd.ndim != 4:
        # an unbatched (T, F, N) input would vmap over frames and feed the
        # squeeze path garbage — fail loudly instead
        raise ValueError(
            "stft_synthesis_batch expects (B, T, nfft//2+1, N); got shape "
            f"{tuple(Xd.shape)} — use stft_synthesis for unbatched input "
            "or add a leading batch axis"
        )
    if win_s is None:
        w = _stft.synthesis_window(_stft.hann(int(nfft)), int(hop))
    else:
        w = np.asarray(win_s)
    y = _stft_synthesis_batch_jit(
        Xd, jnp.asarray(w, real_dtype_of(cdtype)), int(nfft), int(hop)
    )
    return np.asarray(y)


@partial(jax.jit, static_argnames=("nfft", "hop"))
def _stft_analysis_jit(x, nfft, hop):
    X = _stft.analysis(x, nfft, hop)
    return jnp.real(X), jnp.imag(X)


@partial(jax.jit, static_argnames=("nfft", "hop"))
def _stft_analysis_batch_jit(x, nfft, hop):
    X = jax.vmap(lambda xb: _stft.analysis(xb, nfft, hop))(x)
    return jnp.real(X), jnp.imag(X)


@partial(jax.jit, static_argnames=("nfft", "hop"))
def _stft_synthesis_jit(X, nfft, hop):
    return _stft.synthesis(X, nfft, hop)


@partial(jax.jit, static_argnames=("nfft", "hop"))
def _stft_synthesis_win_jit(X, win_s, nfft, hop):
    return _stft.synthesis(X, nfft, hop, win_s)


@partial(jax.jit, static_argnames=("nfft", "hop"))
def _stft_synthesis_batch_jit(X, win_s, nfft, hop):
    return jax.vmap(lambda Xb: _stft.synthesis(Xb, nfft, hop, win_s))(X)


def ilrma(
    X,
    n_src=None,
    n_iter=20,
    proj_back=True,
    W0=None,
    n_components=2,
    return_filters=False,
    callback=None,
    callback_every=10,
    seed=0,
    dtype=None,
    wcov="f32",
):
    """ILRMA (determined, NMF source model). Reference:
    ``pyroomacoustics.bss.ilrma``. NMF init matches the oracle: one
    ``default_rng(seed).random`` draw each for basis and activations.
    ``wcov="bf16"`` as in :func:`overiva`."""
    from .models.ilrma import ilrma_iterations

    X = np.asarray(X)
    T, F, M = X.shape
    N = M if n_src is None else int(n_src)
    if N != M:
        raise ValueError("ilrma is determined: n_src must equal n_chan")
    cdtype = np.dtype(dtype or DEFAULT_DTYPE)
    rdtype = real_dtype_of(cdtype)
    if str(wcov) not in WCOV_MODES:
        raise ValueError(f"wcov must be one of {WCOV_MODES}, got {wcov!r}")

    rng = np.random.default_rng(seed)
    B = (rng.random((N, F, n_components)) + 0.1).astype(rdtype)
    H = (rng.random((N, n_components, T)) + 0.1).astype(rdtype)

    Xd = _to_device(X, cdtype)
    if W0 is not None:
        W = _to_device(W0, cdtype)
    else:
        W = _eye_like(Xd, M)

    Bd, Hd = jnp.asarray(B), jnp.asarray(H)
    if callback is None:
        W, Bd, Hd = ilrma_iterations(Xd, W, Bd, Hd, int(n_iter), str(wcov))
    else:
        done = 0
        while done < n_iter:
            re, im = _snapshot(Xd, W, N)
            callback(merge_np(np.asarray(re), np.asarray(im)))
            step = min(callback_every, n_iter - done)
            W, Bd, Hd = ilrma_iterations(Xd, W, Bd, Hd, step, str(wcov))
            done += step

    re, im = _finalize(Xd, W, N, bool(proj_back))
    Y = merge_np(np.asarray(re), np.asarray(im))
    if return_filters:
        return Y, _to_host(W)
    return Y


@partial(jax.jit, static_argnames=("m",))
def _eye_like(X, m):
    return jnp.tile(jnp.eye(m, dtype=X.dtype), (X.shape[1], 1, 1))


@partial(jax.jit, static_argnames=("taps", "delay", "n_iter", "diag_load"))
def _wpe_jit(X, taps, delay, n_iter, diag_load):
    Y = _wpe_mod.wpe(X, taps=taps, delay=delay, n_iter=n_iter,
                     diag_load=diag_load)
    return jnp.real(Y), jnp.imag(Y)


def wpe(X, taps=10, delay=3, n_iter=3, diag_load=1e-5, dtype=None,
        device=False):
    """WPE dereverberation (extension; the reference repo has no dereverb
    stage). X: (n_frames, n_freq, n_chan) complex STFT -> same shape, with
    late reverberation subtracted by variance-normalized delayed linear
    prediction (Nakatani et al. 2010; see ``oracle/wpe.py`` for the oracle
    twin and the update equations).

    Chain ``Y = wpe(X, device=True)`` into any ``*_batch``/separation call
    to run dereverb + separation fully device-resident.
    """
    if taps < 1:
        raise ValueError("taps must be >= 1")
    if delay < 1:
        raise ValueError("delay must be >= 1 (delay 0 would predict the "
                         "current frame from itself; with 50% STFT overlap "
                         "use delay >= 2)")
    cdtype = np.dtype(dtype or DEFAULT_DTYPE)
    Xd = _to_device(_ensure(X), cdtype)
    re, im = _wpe_jit(Xd, int(taps), int(delay), int(n_iter),
                      float(diag_load))
    return _from_jit(re, im, device)


def wpe_batch(X, taps=10, delay=3, n_iter=3, diag_load=1e-5, dtype=None,
              device=False):
    """Batched WPE: (B, n_frames, n_freq, n_chan) -> same. One vmapped
    fused program over the batch axis (sweep-harness fan-out)."""
    if taps < 1:
        raise ValueError("taps must be >= 1")
    if delay < 1:
        raise ValueError("delay must be >= 1")
    cdtype = np.dtype(dtype or DEFAULT_DTYPE)
    Xd = _to_device(_ensure(X), cdtype)
    re, im = _wpe_batch_jit(Xd, int(taps), int(delay), int(n_iter),
                            float(diag_load))
    return _from_jit(re, im, device)


@partial(jax.jit, static_argnames=("taps", "delay", "n_iter", "diag_load"))
def _wpe_batch_jit(X, taps, delay, n_iter, diag_load):
    f = lambda x: _wpe_mod.wpe(x, taps=taps, delay=delay, n_iter=n_iter,
                               diag_load=diag_load)
    Y = jax.vmap(f)(X)
    return jnp.real(Y), jnp.imag(Y)


def sparseauxiva(
    X,
    S=None,
    n_bins=None,
    n_src=None,
    n_iter=20,
    proj_back=True,
    W0=None,
    model="laplace",
    lasso_iter=300,
    lasso_lam=0.05,
    filter_taps=None,
    acausal_taps=None,
    polish_iter=3,
    return_filters=False,
    callback=None,
    callback_every=10,
    dtype=None,
    wcov="f32",
):
    """SparseAuxIVA: IP updates on a selected bin subset ``S`` + LASSO
    reconstruction of the remaining bins (Jansky, Koldovsky, Ono, IWAENC
    2016 lineage) — extension completing the ``pyroomacoustics.bss``
    family surface. Oracle twin ``overiva_jax.oracle.sparseauxiva``
    carries the design decisions (stratified bin selection, mixing-side
    RTF reconstruction, tap-support restriction, warm-started polish) and
    their A/B measurements.

    Determined (n_src == n_chan). S defaults to the stratified top-power
    F/4 bins, or pass ``n_bins`` (count or fraction of F) — use
    ``n_bins=0.5`` on reverberant rooms, where F/2 + polish matches or
    beats full AuxIVA at ~35 % less IP work (oracle docstring has the
    regime measurements); ``polish_iter`` full-band IP epochs (default 3)
    close the reconstruction gap. ``callback`` receives full-band
    snapshots with zeros at unselected bins during the sparse phase.
    """
    from .models.sparseauxiva import sparse_reconstruct
    from .oracle.sparseauxiva import _resolve_n_bins, select_bins

    # host-side bin selection; see sparseauxiva_batch for why device
    # inputs must come down via the real/imag-split fetch
    X = _to_host(X) if isinstance(X, jax.Array) else np.asarray(X)
    T, F, M = X.shape
    N = M if n_src is None else int(n_src)
    if N != M:
        raise ValueError("sparseauxiva is determined: n_src must equal n_chan")
    if str(wcov) not in WCOV_MODES:
        raise ValueError(f"wcov must be one of {WCOV_MODES}, got {wcov!r}")
    nfft = 2 * (F - 1)
    if S is None:
        S = select_bins(X, _resolve_n_bins(n_bins, F, M))
    S = np.asarray(S)
    if S.ndim != 1 or S.size == 0 or S[-1] >= F or S[0] < 0:
        raise ValueError("S must be a non-empty 1-D array of bin indices < F")
    if np.any(np.diff(S) <= 0):
        raise ValueError("S must be strictly increasing (sorted, unique)")
    n_causal = nfft // 4 if filter_taps is None else int(filter_taps)
    n_acausal = nfft // 16 if acausal_taps is None else int(acausal_taps)
    cdtype = np.dtype(dtype or DEFAULT_DTYPE)

    # ---- phase 1: determined IP updates on the selected bins only ----
    Xsd = _to_device(np.ascontiguousarray(X[:, S, :]), cdtype)
    W0d = (
        _to_device(np.ascontiguousarray(W0[S]), cdtype)
        if W0 is not None else Xsd[:0]
    )
    W_hat, Cx = _prepare(Xsd, W0d, M, False, False, W0 is not None)
    if callback is None:
        W_hat = _core.overiva_iterations(
            Xsd, W_hat, Cx, M, int(n_iter), model, wcov=str(wcov)
        )
    else:
        done = 0
        while done < n_iter:
            re, im = _snapshot(Xsd, W_hat, M)
            full = np.zeros((T, F, M), dtype=cdtype)
            full[:, S, :] = merge_np(np.asarray(re), np.asarray(im))
            callback(full)
            step = min(callback_every, n_iter - done)
            W_hat = _core.overiva_iterations(
                Xsd, W_hat, Cx, M, step, model, wcov=str(wcov)
            )
            done += step

    # ---- phase 2: RTF LASSO reconstruction of the unselected bins ----
    if S.size == F:
        W_full = W_hat  # exact AuxIVA degeneration
        Xd = Xsd
    else:
        W_full = sparse_reconstruct(
            W_hat, jnp.asarray(S, jnp.int32), F, nfft, n_causal,
            n_acausal, int(lasso_iter), float(lasso_lam),
        )
        Xd = _to_device(X, cdtype)
        # ---- phase 3: optional full-band polish, warm-started ----
        if polish_iter > 0:
            W_full, Cx_full = _prepare(Xd, W_full, M, False, False, True)
            W_full = _core.overiva_iterations(
                Xd, W_full, Cx_full, M, int(polish_iter), model, wcov=str(wcov)
            )

    re, im = _finalize(Xd, W_full, M, bool(proj_back))
    Y = merge_np(np.asarray(re), np.asarray(im))
    if return_filters:
        return Y, _to_host(W_full)
    return Y


def _fastmnmf_impl(
    X,
    n_src=None,
    n_iter=30,
    n_components=2,
    mic_index=0,
    init="whiten",
    n_noise="auto",
    return_filters=False,
    callback=None,
    callback_every=10,
    seed=0,
    dtype=None,
    wcov="f32",
    tie_g=True,
    n_q_sweeps=1,
):
    """Shared FastMNMF1/2 driver (``tie_g`` selects the variant) —
    extension beyond the reference repo (Sekiguchi et al., IEEE/ACM TASLP
    2020 for FastMNMF2 / EUSIPCO 2019 for FastMNMF1; oracle twin
    ``overiva_jax.oracle.fastmnmf2`` carries the derivation, the
    likelihood-monotonicity validation, and the init / noise-slot design
    notes).

    X: (n_frames, n_freq, n_chan) complex. Returns Y (n_frames, n_freq,
    n_src) — multichannel-Wiener source images at ``mic_index`` (already
    minimally distorted; no projection back step exists in this model)
    [, (Q, g, W, H) of the full model if ``return_filters``]. Init matches
    the oracle: whitened (or identity) Q, diag-dominant g, one
    ``default_rng(seed).random`` draw each for the NMF basis/activations.
    ``n_noise`` extra slots ("auto": fill to n_chan total — fewer slots
    than channels routinely lands in non-separating optima, oracle
    docstring has the data) absorb the noise floor and the unmodeled
    channels; the n_src highest-energy images are returned.
    """
    from .models.fastmnmf2 import fastmnmf2_iterations

    X = np.asarray(X)
    T, F, M = X.shape
    # Measured regime boundary (PARITY.md "FastMNMF long-horizon regime
    # boundary"): with starved frames the full-rank model overfits at long
    # horizons in ANY precision — f64 drifts, f32 collapses to garbage /
    # non-finite. Warn before the user hits the documented cliff.
    if T < 150 and n_iter > 60:
        import warnings

        warnings.warn(
            f"FastMNMF with only T={T} frames and n_iter={n_iter}: below "
            "the measured safe regime (T >= ~150 for 100+ epochs — "
            "PARITY.md). The full-rank model overfits starved frames at "
            "long horizons; float32 can go non-finite. Use a smaller nfft "
            "(more frames) or n_iter <= 60.",
            UserWarning,
            stacklevel=3,
        )
    N_out = M if n_src is None else int(n_src)
    if N_out < 1:
        raise ValueError("need n_src >= 1")
    if init not in ("whiten", "eye"):
        raise ValueError(f"init must be 'whiten' or 'eye', got {init!r}")
    if str(wcov) not in WCOV_MODES:
        raise ValueError(f"wcov must be one of {WCOV_MODES}, got {wcov!r}")
    if n_noise == "auto":
        n_noise = M - N_out if N_out < M else 0
    N = N_out + int(n_noise)
    cdtype = np.dtype(dtype or DEFAULT_DTYPE)
    rdtype = real_dtype_of(cdtype)

    rng = np.random.default_rng(seed)
    g = np.full((N, M), 1e-2)
    for n in range(N):
        g[n, n % M] = 1.0
    g /= g.sum(axis=1, keepdims=True)
    if not tie_g:  # FastMNMF1: free per-frequency spatial weights
        g = np.tile(g[:, None, :], (1, F, 1))
    W = (rng.random((N, F, n_components)) + 0.1).astype(rdtype)
    H = (rng.random((N, n_components, T)) + 0.1).astype(rdtype)

    Xd = _to_device(X, cdtype)
    Xd, x_scale = _unit_power_jit(Xd)  # see models.fastmnmf2.unit_power
    Q = _whiten_q(Xd) if init == "whiten" else _eye_like(Xd, M)
    gd, Wd, Hd = jnp.asarray(g.astype(rdtype)), jnp.asarray(W), jnp.asarray(H)

    def snapshot(state):
        re, im = _fastmnmf2_snapshot(Xd, *state, x_scale, int(mic_index), N_out)
        return merge_np(np.asarray(re), np.asarray(im))

    state = (Q, gd, Wd, Hd)
    if callback is None:
        state = fastmnmf2_iterations(
            Xd, *state, int(n_iter), wcov=str(wcov),
            n_q_sweeps=int(n_q_sweeps),
        )
    else:
        done = 0
        while done < n_iter:
            callback(snapshot(state))
            step = min(callback_every, n_iter - done)
            state = fastmnmf2_iterations(
                Xd, *state, step, wcov=str(wcov),
                n_q_sweeps=int(n_q_sweeps),
            )
            done += step

    Y = snapshot(state)
    if return_filters:
        return Y, (_to_host(state[0]),) + tuple(
            np.asarray(s) for s in state[1:]
        )
    return Y


def fastmnmf2(X, **kwargs):
    """FastMNMF2: full-rank spatial model with jointly-diagonalizable
    SCMs, spatial weights g (N, M) TIED across frequency (Sekiguchi et
    al., IEEE/ACM TASLP 2020). See ``_fastmnmf_impl`` for parameters; the
    oracle twin ``overiva_jax.oracle.fastmnmf2`` carries the design
    notes. Usually the better default of the two variants: the tying is
    an implicit permutation alignment.
    """
    return _fastmnmf_impl(X, tie_g=True, **kwargs)


def fastmnmf(X, **kwargs):
    """FastMNMF1: as :func:`fastmnmf2` but with free per-frequency
    spatial weights g (N, F, M) (Sekiguchi et al., EUSIPCO 2019). More
    flexible, but loses the implicit permutation alignment of the tied
    variant; completes the published family (pyroomacoustics ships both).
    Its g update is per-frequency local — under bin sharding it needs no
    collective.
    """
    return _fastmnmf_impl(X, tie_g=False, **kwargs)


@jax.jit
def _whiten_q(X):
    from .models.fastmnmf2 import whiten_q

    return whiten_q(X)


@jax.jit
def _unit_power_jit(X):
    from .models.fastmnmf2 import unit_power

    return unit_power(X)


@partial(jax.jit, static_argnames=("mic_index", "n_out"))
def _fastmnmf2_snapshot(X, Q, g, W, H, x_scale, mic_index, n_out):
    from .models.fastmnmf2 import fastmnmf2_wiener

    Y = fastmnmf2_wiener(X, Q, g, W, H, mic_index) * x_scale
    if n_out < Y.shape[2]:
        en = jnp.sum(jnp.abs(Y) ** 2, axis=(0, 1))
        pick = jnp.sort(jnp.argsort(-en)[:n_out])
        Y = jnp.take(Y, pick, axis=2)
    return jnp.real(Y), jnp.imag(Y)


# ------------------------------------------------- fully fused time pipeline

@partial(
    jax.jit,
    static_argnames=(
        "nfft", "hop", "n_src", "n_iter", "model", "init_eig", "algo",
        "wpe_taps", "wpe_delay", "wpe_n_iter", "tiss_taps", "tiss_delay",
    ),
)
def _separate_time_jit(x, nfft, hop, n_src, n_iter, model, init_eig,
                       algo="ip", wpe_taps=0, wpe_delay=3, wpe_n_iter=3,
                       tiss_taps=5, tiss_delay=2):
    from .models.auxiva_iss import auxiva_iss_iterations
    from .models.overiva import overiva_run
    from .models.overiva_ip2 import overiva_ip2_iterations
    from .models.tiss import augment_taps, augmented_eye, tiss_iterations
    from .ops.projection import apply_projection_back

    X = _stft.analysis(x, nfft, hop)
    if wpe_taps:  # fused dereverb front (still the same single XLA program)
        X = _wpe_mod.wpe(X, taps=wpe_taps, delay=wpe_delay,
                         n_iter=wpe_n_iter)
    if algo == "iss":  # rank-1 steering (OverIVA-ISS when n_src < M)
        M = X.shape[2]
        W = jnp.broadcast_to(jnp.eye(M, dtype=X.dtype), (X.shape[1], M, M))
        _, Y = auxiva_iss_iterations(X, W, n_iter, model, n_src=n_src)
        Y = Y[:, :, :n_src]
    elif algo == "tiss":  # joint dereverb + separation (rank-1 steering)
        M = X.shape[2]
        Xt = augment_taps(X, tiss_taps, tiss_delay)
        P = augmented_eye(Xt, M)
        _, Y = tiss_iterations(Xt, P, n_iter, model, M, n_src=n_src)
        Y = Y[:, :, :n_src]
    elif algo == "tip":  # joint dereverb + separation (exact IP rows)
        from .models.tip import tip_iterations

        M = X.shape[2]
        Xt = augment_taps(X, tiss_taps, tiss_delay)
        P = augmented_eye(Xt, M)
        if tiss_taps:  # warm start (measured essential — oracle/tip.py)
            P, _ = tiss_iterations(Xt, P, 10, model, M, n_src=n_src)
        P = tip_iterations(Xt, P, n_iter, model, M, n_src=n_src)
        Y = _core.demix(Xt, P)[:, :, :n_src]
    elif algo == "ilrma_t":  # joint dereverb + ILRMA (NMF model, steering)
        from .models.ilrma_t import ilrma_t_iterations

        T, F, M = X.shape
        L = 2
        Xt = augment_taps(X, tiss_taps, tiss_delay)
        P = augmented_eye(Xt, M)
        rdt = jnp.finfo(X.dtype).dtype
        k1, k2 = jax.random.split(jax.random.PRNGKey(0))
        Bn = jax.random.uniform(k1, (M, F, L), rdt) + 0.1
        Hn = jax.random.uniform(k2, (M, L, T), rdt) + 0.1
        _, Y, _, _ = ilrma_t_iterations(Xt, P, Bn, Hn, n_iter, M)
        if n_src < M:
            en = jnp.sum(jnp.abs(Y) ** 2, axis=(0, 1))
            pick = jnp.sort(jnp.argsort(-en)[:n_src])
            Y = jnp.take(Y, pick, axis=2)
    elif algo == "ip2":  # pairwise joint updates (needs n_src >= 2)
        W_hat, Cx = _prepare(X, X[:0], n_src, False, True, False)
        W_hat = overiva_ip2_iterations(X, W_hat, Cx, n_src, n_iter, model)
        Y = _core.demix(X, W_hat[:, :n_src, :])
    elif algo in ("fastmnmf", "fastmnmf2"):
        # full-rank spatial model; Wiener images at mic 0 are already
        # minimally distorted — no projection back. NMF init uses
        # jax.random (deterministic key) instead of the numpy init of
        # api.fastmnmf2: the fused pipeline cannot take host arrays.
        from .models.fastmnmf2 import (
            fastmnmf2_iterations,
            fastmnmf2_wiener,
            unit_power,
            whiten_q,
        )

        T, F, M = X.shape
        L = 2
        Xu, x_scale = unit_power(X)
        Q = whiten_q(Xu)
        rdt = jnp.finfo(X.dtype).dtype
        g = jnp.full((M, M), 1e-2, rdt)
        g = g.at[jnp.arange(M), jnp.arange(M)].set(1.0)
        g = g / jnp.sum(g, axis=1, keepdims=True)
        if algo == "fastmnmf":  # FastMNMF1: per-frequency spatial weights
            g = jnp.broadcast_to(g[:, None, :], (M, F, M))
        k1, k2 = jax.random.split(jax.random.PRNGKey(0))
        Wn = jax.random.uniform(k1, (M, F, L), rdt) + 0.1
        Hn = jax.random.uniform(k2, (M, L, T), rdt) + 0.1
        Q, g, Wn, Hn = fastmnmf2_iterations(Xu, Q, g, Wn, Hn, n_iter)
        Y = fastmnmf2_wiener(Xu, Q, g, Wn, Hn, 0) * x_scale
        if n_src < M:
            en = jnp.sum(jnp.abs(Y) ** 2, axis=(0, 1))
            pick = jnp.sort(jnp.argsort(-en)[:n_src])
            Y = jnp.take(Y, pick, axis=2)
        return _stft.synthesis(Y, nfft, hop)
    else:
        Y, _ = overiva_run(X, n_src, n_iter, model, init_eig=init_eig)
    Y = apply_projection_back(Y, X[:, :, 0])
    return _stft.synthesis(Y, nfft, hop)


def separate(
    mix,
    n_src=None,
    nfft=4096,
    hop=None,
    n_iter=20,
    model="laplace",
    init_eig=False,
    algo="ip",
    dtype=None,
    wpe=None,
    taps=5,
    delay=2,
):
    """Time-domain in, time-domain out: STFT -> [WPE] -> separate ->
    projection back -> iSTFT as ONE fused XLA program (zero host
    round-trips, no complex at any boundary — the serving path).

    ``algo``: "ip" (OverIVA/AuxIVA iterative projection, reference-parity),
    "iss" (rank-1 source steering; OverIVA-ISS when n_src < n_chan),
    "ip2" (pairwise joint updates, 3-5x fewer iterations; n_src >= 2),
    "tiss" (JOINT dereverberation + separation by steering on delayed
    taps — ``taps``/``delay`` apply; prefer over the wpe-cascade when the
    window is much shorter than the reverb tail),
    "tip" (joint with exact IP rows, 10 warm T-ISS epochs built in —
    use ``model="gauss"``, short ``n_iter``; ``taps``/``delay`` apply),
    "ilrma_t" (joint dereverb + ILRMA, NMF init from a fixed jax.random
    key; ``taps``/``delay`` apply; extra outputs picked by energy),
    or "fastmnmf"/"fastmnmf2" (full-rank spatial model, Wiener images at
    mic 0; NMF init from a fixed jax.random key, 30 epochs recommended).
    ``wpe``: None, True, or a dict of :func:`wpe` options — fuses the
    dereverberation front into the same program.
    mix: (n_samples, n_chan) float. Returns (n_samples, n_src) float.
    """
    if algo not in (
        "ip", "iss", "ip2", "tiss", "tip", "ilrma_t", "fastmnmf", "fastmnmf2"
    ):
        raise ValueError(
            f"unknown algo {algo!r}; use 'ip', 'iss', 'ip2', 'tiss', 'tip',"
            " 'ilrma_t', 'fastmnmf' or 'fastmnmf2'"
        )
    mix = np.asarray(mix)
    hop = hop or nfft // 2
    n, M = mix.shape
    N = M if n_src is None else int(n_src)
    if not 1 <= N <= M:
        raise ValueError("need 1 <= n_src <= n_chan")
    if algo == "ip2" and N < 2:
        raise ValueError("algo='ip2' needs n_src >= 2")
    rdtype = real_dtype_of(np.dtype(dtype or DEFAULT_DTYPE))

    from .oracle.stft import stft_pad

    wkw = {"taps": 10, "delay": 3, "n_iter": 3}
    if isinstance(wpe, dict):
        bad = set(wpe) - {"taps", "delay", "n_iter"}
        if bad:
            raise ValueError(f"unknown wpe option(s): {sorted(bad)}")
        wkw.update(wpe)
    xp = stft_pad(mix, nfft, hop).astype(rdtype)
    y = np.asarray(
        _separate_time_jit(
            jnp.asarray(xp), int(nfft), int(hop), N, int(n_iter), model,
            bool(init_eig), algo,
            wpe_taps=int(wkw["taps"]) if wpe else 0,
            wpe_delay=int(wkw["delay"]), wpe_n_iter=int(wkw["n_iter"]),
            tiss_taps=int(taps), tiss_delay=int(delay),
        )
    )
    start = nfft - hop
    return y[start : start + n]


# ------------------------------------------------------- batched separation

@partial(
    jax.jit, static_argnames=("n_src", "n_iter", "model", "init_eig", "proj_back")
)
def _overiva_batch_jit(X, n_src, n_iter, model, init_eig, proj_back):
    from .models.overiva import overiva_run
    from .ops.projection import apply_projection_back

    def one(Xb):
        Y, _ = overiva_run(Xb, n_src, n_iter, model, init_eig=init_eig)
        if proj_back:
            Y = apply_projection_back(Y, Xb[:, :, 0])
        return Y

    Y = jax.vmap(one)(X)
    return jnp.real(Y), jnp.imag(Y)


def overiva_batch(
    X,
    n_src=None,
    n_iter=20,
    proj_back=True,
    model="laplace",
    init_eig=False,
    dtype=None,
    device=False,
):
    """Separate a batch of same-shape mixtures in ONE fused XLA program.

    X: (batch, n_frames, n_freq, n_chan) complex (host ndarray or a
    device array from :func:`to_device` — the latter skips the upload).
    Returns (batch, n_frames, n_freq, n_src); ``device=True`` keeps the
    result on the device (skips the download). Single-chip throughput path
    (vmap over mixtures); for multi-chip see ``overiva_jax.parallel.sharded``.
    No callback support (use :func:`overiva` per mixture for that).
    """
    X = _ensure(X)
    B, T, F, M = X.shape
    N = M if n_src is None else int(n_src)
    if not 1 <= N <= M:
        raise ValueError("need 1 <= n_src <= n_chan")
    Xd = _to_device(X, np.dtype(dtype or DEFAULT_DTYPE))
    re, im = _overiva_batch_jit(
        Xd, N, int(n_iter), model, bool(init_eig), bool(proj_back)
    )
    return _from_jit(re, im, device)


@partial(
    jax.jit, static_argnames=("n_src", "n_iter", "model", "proj_back")
)
def _ip2_batch_jit(X, n_src, n_iter, model, proj_back):
    from .models.overiva_ip2 import overiva_ip2_iterations
    from .ops.projection import apply_projection_back

    def one(Xb):
        W_hat, Cx = _prepare(Xb, Xb[:0], n_src, False, True, False)
        W_hat = overiva_ip2_iterations(Xb, W_hat, Cx, n_src, n_iter, model)
        Y = _core.demix(Xb, W_hat[:, :n_src, :])
        if proj_back:
            Y = apply_projection_back(Y, Xb[:, :, 0])
        return Y

    Y = jax.vmap(one)(X)
    return jnp.real(Y), jnp.imag(Y)


def overiva_ip2_batch(
    X, n_src=None, n_iter=10, proj_back=True, model="laplace", dtype=None,
    device=False,
):
    """Batch of same-shape mixtures through OverIVA-IP2 in ONE fused XLA
    program. X: (batch, T, F, M) -> (batch, T, F, n_src). Accepts
    :func:`to_device` arrays; ``device=True`` keeps the result on device."""
    X = _ensure(X)
    B, T, F, M = X.shape
    N = M if n_src is None else int(n_src)
    if not 2 <= N <= M:
        raise ValueError(f"IP2 needs 2 <= n_src <= n_chan, got {N}")
    Xd = _to_device(X, np.dtype(dtype or DEFAULT_DTYPE))
    re, im = _ip2_batch_jit(Xd, N, int(n_iter), model, bool(proj_back))
    return _from_jit(re, im, device)


@partial(
    jax.jit, static_argnames=("n_iter", "mic_index", "init", "n_out")
)
def _fastmnmf2_batch_jit(X, g, W, H, n_iter, mic_index, init, n_out):
    from .models.fastmnmf2 import fastmnmf2_iterations, fastmnmf2_wiener

    M = X.shape[3]

    def one(Xb, Wb, Hb):
        from .models.fastmnmf2 import unit_power

        Xb, x_scale = unit_power(Xb)
        Q = _whiten_q(Xb) if init == "whiten" else _eye_like(Xb, M)
        Q, gq, Wq, Hq = fastmnmf2_iterations(Xb, Q, g, Wb, Hb, n_iter)
        Y = fastmnmf2_wiener(Xb, Q, gq, Wq, Hq, mic_index) * x_scale
        if n_out < Y.shape[2]:
            en = jnp.sum(jnp.abs(Y) ** 2, axis=(0, 1))
            pick = jnp.sort(jnp.argsort(-en)[:n_out])
            Y = jnp.take_along_axis(Y, pick[None, None, :], axis=2)
        return Y

    Y = jax.vmap(one)(X, W, H)
    return jnp.real(Y), jnp.imag(Y)


def fastmnmf2_batch(
    X,
    n_src=None,
    n_iter=30,
    n_components=2,
    mic_index=0,
    init="whiten",
    n_noise="auto",
    seed=0,
    seeds=None,
    dtype=None,
    tie_g=True,
    device=False,
):
    """Batch of same-shape mixtures through FastMNMF2 in ONE fused XLA
    program. X: (batch, T, F, M) -> (batch, T, F, n_src). Element b's NMF
    init matches ``fastmnmf2(X[b], seed=seed + b)`` — or ``seed=seeds[b]``
    when an explicit per-element ``seeds`` sequence is given (the sweep
    harness uses ``seeds=[s]*B`` to reproduce its single-instance runs
    exactly). ``tie_g=False`` selects FastMNMF1 (see :func:`fastmnmf`).
    Accepts :func:`to_device` arrays; ``device=True`` keeps the result on
    device.
    """
    X = _ensure(X)
    B, T, F, M = X.shape
    N_out = M if n_src is None else int(n_src)
    if N_out < 1:
        raise ValueError("need n_src >= 1")
    if init not in ("whiten", "eye"):
        raise ValueError(f"init must be 'whiten' or 'eye', got {init!r}")
    if n_noise == "auto":
        n_noise = M - N_out if N_out < M else 0
    N = N_out + int(n_noise)
    cdtype = np.dtype(dtype or DEFAULT_DTYPE)
    rdtype = real_dtype_of(cdtype)

    g = np.full((N, M), 1e-2)
    for n in range(N):
        g[n, n % M] = 1.0
    g /= g.sum(axis=1, keepdims=True)
    if not tie_g:  # FastMNMF1: free per-frequency spatial weights
        g = np.tile(g[:, None, :], (1, F, 1))
    if seeds is None:
        seeds = [seed + b for b in range(B)]
    if len(seeds) != B:
        raise ValueError(f"seeds must have batch length {B}")
    W = np.empty((B, N, F, n_components), rdtype)
    H = np.empty((B, N, n_components, T), rdtype)
    for b in range(B):
        rng = np.random.default_rng(seeds[b])
        W[b] = (rng.random((N, F, n_components)) + 0.1).astype(rdtype)
        H[b] = (rng.random((N, n_components, T)) + 0.1).astype(rdtype)

    Xd = _to_device(X, cdtype)
    re, im = _fastmnmf2_batch_jit(
        Xd, jnp.asarray(g.astype(rdtype)), jnp.asarray(W), jnp.asarray(H),
        int(n_iter), int(mic_index), init, N_out,
    )
    return _from_jit(re, im, device)


def fastmnmf_batch(X, **kwargs):
    """Batched FastMNMF1 (per-frequency spatial weights): see
    :func:`fastmnmf2_batch` for parameters."""
    return fastmnmf2_batch(X, tie_g=False, **kwargs)


@partial(
    jax.jit,
    static_argnames=(
        "n_iter", "model", "proj_back", "nfft", "n_causal", "n_acausal",
        "lasso_iter", "polish_iter",
    ),
)
def _sparse_batch_jit(
    X, S, lam_ratio, n_iter, model, proj_back, nfft, n_causal, n_acausal,
    lasso_iter, polish_iter,
):
    from .models.sparseauxiva import sparse_reconstruct
    from .ops.covariance import covariance
    from .ops.projection import apply_projection_back

    B, T, F, M = X.shape

    def one(Xb, Sb):
        Xs = jnp.take(Xb, Sb, axis=1)  # (T, k, M) per-element bin gather
        W = jnp.broadcast_to(jnp.eye(M, dtype=Xb.dtype), (Xs.shape[1], M, M))
        Cx_s = jnp.zeros((Xs.shape[1], M, M), Xb.dtype)  # unused at N == M
        W = _core.overiva_iterations(Xs, W, Cx_s, M, n_iter, model)
        W_full = sparse_reconstruct(
            W, Sb, F, nfft, n_causal, n_acausal, lasso_iter, lam_ratio
        )
        if polish_iter > 0:
            Cx_f = jnp.zeros((F, M, M), Xb.dtype)
            W_full = _core.overiva_iterations(
                Xb, W_full, Cx_f, M, polish_iter, model
            )
        Y = _core.demix(Xb, W_full)
        if proj_back:
            Y = apply_projection_back(Y, Xb[:, :, 0])
        return Y

    Y = jax.vmap(one)(X, S)
    return jnp.real(Y), jnp.imag(Y)


def sparseauxiva_batch(
    X,
    n_bins=None,
    n_src=None,
    n_iter=20,
    proj_back=True,
    model="laplace",
    lasso_iter=300,
    lasso_lam=0.05,
    filter_taps=None,
    acausal_taps=None,
    polish_iter=3,
    dtype=None,
    device=False,
):
    """Batch of same-shape mixtures through SparseAuxIVA in ONE fused XLA
    program. X: (batch, T, F, M) -> (batch, T, F, M). Bin subsets are
    selected per element (stratified top power, so every element has the
    same subset SIZE); see :func:`sparseauxiva` for the parameters and
    regime guidance. ``device=True`` keeps the result on device (the input
    is still pulled to host once — bin selection is host-side).
    """
    from .oracle.sparseauxiva import _resolve_n_bins, select_bins

    # Bin selection is host-side: pull device inputs down via the
    # real/imag-split path (the package's float-plane host boundary).
    X = _to_host(X) if isinstance(X, jax.Array) else np.asarray(X)
    B, T, F, M = X.shape
    N = M if n_src is None else int(n_src)
    if N != M:
        raise ValueError("sparseauxiva is determined: n_src must equal n_chan")
    nfft = 2 * (F - 1)
    k = _resolve_n_bins(n_bins, F, M)
    S = np.stack([select_bins(X[b], k) for b in range(B)])
    if S.shape[1] == F:
        raise ValueError("all bins selected: use auxiva_iss/overiva_batch")
    n_causal = nfft // 4 if filter_taps is None else int(filter_taps)
    n_acausal = nfft // 16 if acausal_taps is None else int(acausal_taps)
    cdtype = np.dtype(dtype or DEFAULT_DTYPE)

    Xd = _to_device(X, cdtype)
    re, im = _sparse_batch_jit(
        Xd, jnp.asarray(S, jnp.int32), float(lasso_lam), int(n_iter),
        str(model), bool(proj_back), nfft, n_causal, n_acausal,
        int(lasso_iter), int(polish_iter),
    )
    return _from_jit(re, im, device)


@partial(
    jax.jit, static_argnames=("n_src", "n_iter", "model", "proj_back")
)
def _iss_batch_jit(X, n_src, n_iter, model, proj_back):
    from .models.auxiva_iss import _iss_epoch
    from .models.overiva import demix
    from .ops.projection import apply_projection_back

    M = X.shape[3]

    def one(Xb):
        W = jnp.broadcast_to(jnp.eye(M, dtype=Xb.dtype), (Xb.shape[1], M, M))
        Y = demix(Xb, W)
        _, Y = jax.lax.fori_loop(
            0, n_iter, lambda _, s: _iss_epoch(Xb, s, model, n_src=n_src), (W, Y)
        )
        if n_src is not None:
            Y = Y[:, :, :n_src]
        if proj_back:
            Y = apply_projection_back(Y, Xb[:, :, 0])
        return Y

    Y = jax.vmap(one)(X)
    return jnp.real(Y), jnp.imag(Y)


def auxiva_iss_batch(
    X, n_src=None, n_iter=20, proj_back=True, model="laplace", dtype=None,
    device=False,
):
    """Batch of same-shape mixtures through AuxIVA-ISS (OverIVA-ISS when
    ``n_src < n_chan``) in ONE fused XLA program.

    X: (batch, n_frames, n_freq, n_chan) complex -> (batch, ..., n_src).
    Accepts :func:`to_device` arrays; ``device=True`` keeps the result on
    device. Single-chip throughput path; no callbacks (use the per-mixture
    API)."""
    X = _ensure(X)
    B, T, F, M = X.shape
    N = M if n_src is None else int(n_src)
    if not 1 <= N <= M:
        raise ValueError("need 1 <= n_src <= n_chan")
    Xd = _to_device(X, np.dtype(dtype or DEFAULT_DTYPE))
    re, im = _iss_batch_jit(Xd, N, int(n_iter), model, bool(proj_back))
    return _from_jit(re, im, device)


def overiva_iss_batch(X, n_src, **kw):
    """Alias of :func:`auxiva_iss_batch` with a required n_src."""
    return auxiva_iss_batch(X, n_src=n_src, **kw)


@partial(
    jax.jit,
    static_argnames=("n_src", "taps", "delay", "n_iter", "model", "proj_back"),
)
def _tiss_batch_jit(X, n_src, taps, delay, n_iter, model, proj_back):
    from .models.overiva import demix
    from .models.tiss import _tiss_epoch, augment_taps, augmented_eye
    from .ops.projection import apply_projection_back

    M = X.shape[3]

    def one(Xb):
        Xt = augment_taps(Xb, taps, delay)
        P = augmented_eye(Xt, M)
        Y = demix(Xt, P)
        _, Y = jax.lax.fori_loop(
            0,
            n_iter,
            lambda _, s: _tiss_epoch(Xt, s, model, M, n_src=n_src),
            (P, Y),
        )
        Y = Y[:, :, :n_src]
        if proj_back:
            Y = apply_projection_back(Y, Xb[:, :, 0])
        return Y

    Y = jax.vmap(one)(X)
    return jnp.real(Y), jnp.imag(Y)


def tiss_batch(
    X, n_src=None, taps=5, delay=2, n_iter=20, proj_back=True,
    model="laplace", dtype=None, device=False,
):
    """Batch of same-shape mixtures through T-ISS (joint dereverberation +
    separation, see :func:`tiss`) in ONE fused XLA program.

    X: (batch, n_frames, n_freq, n_chan) complex -> (batch, ..., n_src).
    Accepts :func:`to_device` arrays; ``device=True`` keeps the result on
    device."""
    X = _ensure(X)
    B, T, F, M = X.shape
    N = M if n_src is None else int(n_src)
    if not 1 <= N <= M:
        raise ValueError("need 1 <= n_src <= n_chan")
    taps, delay = int(taps), int(delay)
    if taps < 0 or (taps > 0 and delay < 1):
        raise ValueError("need taps >= 0 and delay >= 1 when taps > 0")
    Xd = _to_device(X, np.dtype(dtype or DEFAULT_DTYPE))
    re, im = _tiss_batch_jit(
        Xd, N, taps, delay, int(n_iter), model, bool(proj_back)
    )
    return _from_jit(re, im, device)


@partial(
    jax.jit,
    static_argnames=(
        "n_src", "taps", "delay", "n_iter", "warm_iter", "model", "proj_back",
        "wcov",
    ),
)
def _tip_batch_jit(
    X, n_src, taps, delay, n_iter, warm_iter, model, proj_back, wcov="f32"
):
    from .models.tip import tip_iterations
    from .models.tiss import augment_taps, augmented_eye, tiss_iterations
    from .models.overiva import demix
    from .ops.projection import apply_projection_back

    M = X.shape[3]

    def one(Xb):
        Xt = augment_taps(Xb, taps, delay)
        P = augmented_eye(Xt, M)
        if warm_iter > 0 and taps > 0:
            P, _ = tiss_iterations(Xt, P, warm_iter, model, M, n_src=n_src)
        P = tip_iterations(Xt, P, n_iter, model, M, n_src=n_src, wcov=wcov)
        Y = demix(Xt, P)[:, :, :n_src]
        if proj_back:
            Y = apply_projection_back(Y, Xb[:, :, 0])
        return Y

    Y = jax.vmap(one)(X)
    return jnp.real(Y), jnp.imag(Y)


def tip_batch(
    X, n_src=None, taps=5, delay=2, n_iter=10, warm_iter=10, proj_back=True,
    model="laplace", dtype=None, wcov="f32", device=False,
):
    """Batch of same-shape mixtures through T-IP (see :func:`tip`) in ONE
    fused XLA program (warm-up T-ISS epochs included in-program).

    X: (batch, n_frames, n_freq, n_chan) complex -> (batch, ..., n_src)."""
    X = _ensure(X)
    B, T, F, M = X.shape
    N = M if n_src is None else int(n_src)
    if not 1 <= N <= M:
        raise ValueError("need 1 <= n_src <= n_chan")
    taps, delay = int(taps), int(delay)
    if taps < 0 or (taps > 0 and delay < 1):
        raise ValueError("need taps >= 0 and delay >= 1 when taps > 0")
    if str(wcov) not in WCOV_MODES:
        raise ValueError(f"wcov must be one of {WCOV_MODES}, got {wcov!r}")
    Xd = _to_device(X, np.dtype(dtype or DEFAULT_DTYPE))
    re, im = _tip_batch_jit(
        Xd, N, taps, delay, int(n_iter), int(warm_iter), model,
        bool(proj_back), str(wcov),
    )
    return _from_jit(re, im, device)


@partial(
    jax.jit,
    static_argnames=("taps", "delay", "n_iter", "proj_back"),
)
def _ilrma_t_batch_jit(X, B0, H0, taps, delay, n_iter, proj_back):
    from .models.ilrma_t import augment_taps, ilrma_t_iterations
    from .models.tiss import augmented_eye
    from .ops.projection import apply_projection_back

    M = X.shape[3]

    def one(Xb, Bb, Hb):
        Xt = augment_taps(Xb, taps, delay)
        P = augmented_eye(Xt, M)
        _, Y, _, _ = ilrma_t_iterations(Xt, P, Bb, Hb, n_iter, M)
        if proj_back:
            Y = apply_projection_back(Y, Xb[:, :, 0])
        return Y

    Y = jax.vmap(one)(X, B0, H0)
    return jnp.real(Y), jnp.imag(Y)


def ilrma_t_batch(
    X,
    n_src=None,
    taps=5,
    delay=2,
    n_iter=20,
    proj_back=True,
    n_components=2,
    seed=0,
    seeds=None,
    dtype=None,
    device=False,
):
    """Batch of same-shape mixtures through ILRMA-T (joint dereverberation
    + ILRMA, see :func:`ilrma_t`) in ONE fused XLA program.

    X: (batch, T, F, M) -> (batch, T, F, M). Element b's NMF init matches
    ``ilrma_t(X[b], seed=seed + b)`` — or ``seed=seeds[b]`` with an
    explicit per-element ``seeds`` sequence. Accepts :func:`to_device`
    arrays; ``device=True`` keeps the result on device."""
    X = _ensure(X)
    B, T, F, M = X.shape
    N = M if n_src is None else int(n_src)
    if N != M:
        raise ValueError("ilrma_t is determined: n_src must equal n_chan")
    taps, delay = int(taps), int(delay)
    if taps < 0 or (taps > 0 and delay < 1):
        raise ValueError("need taps >= 0 and delay >= 1 when taps > 0")
    cdtype = np.dtype(dtype or DEFAULT_DTYPE)
    rdtype = real_dtype_of(cdtype)
    if seeds is None:
        seeds = [seed + b for b in range(B)]
    if len(seeds) != B:
        raise ValueError(f"seeds must have batch length {B}")

    B0 = np.empty((B, M, F, n_components), rdtype)
    H0 = np.empty((B, M, n_components, T), rdtype)
    for b in range(B):
        rng = np.random.default_rng(seeds[b])
        B0[b] = (rng.random((M, F, n_components)) + 0.1).astype(rdtype)
        H0[b] = (rng.random((M, n_components, T)) + 0.1).astype(rdtype)

    Xd = _to_device(X, cdtype)
    re, im = _ilrma_t_batch_jit(
        Xd, jnp.asarray(B0), jnp.asarray(H0), taps, delay, int(n_iter),
        bool(proj_back),
    )
    return _from_jit(re, im, device)


@partial(
    jax.jit,
    static_argnames=(
        "n_iter", "model", "update", "switch_every", "init_eig", "proj_back"
    ),
)
def _ogive_batch_jit(
    X, step_size, tol, n_iter, model, update, switch_every, init_eig, proj_back
):
    from .ops.projection import apply_projection_back

    def one(Xb):
        w, a, Cx, Cx_inv = _ogive_mod.ogive_init(Xb, init_eig)
        use_mix = jnp.zeros((Xb.shape[1],), bool)
        w, a, use_mix, epoch, done = _ogive_mod.ogive_iterations(
            Xb, w, a, use_mix, Cx, Cx_inv, jnp.asarray(0, jnp.int32),
            step_size, tol, n_iter, model, update, switch_every,
        )
        Y = _ogive_mod.ogive_demix(Xb, w)[:, :, None]
        if proj_back:
            Y = apply_projection_back(Y, Xb[:, :, 0])
        return Y, epoch

    Y, epochs = jax.vmap(one)(X)
    return jnp.real(Y), jnp.imag(Y), epochs


def ogive_batch(
    X,
    n_iter=4000,
    step_size=0.1,
    tol=1e-3,
    update="demix",
    proj_back=True,
    model="laplace",
    init_eig=False,
    switch_every=10,
    return_epochs=False,
    dtype=None,
    device=False,
):
    """Batch of same-shape mixtures through OGIVE in ONE fused XLA program.

    The per-element early exit is preserved: converged mixtures freeze while
    the batched while_loop runs on for the rest (models/ogive.py body
    masking). ``return_epochs`` additionally returns each element's
    iteration count. X: (batch, T, F, M) -> (batch, T, F, 1). Accepts
    :func:`to_device` arrays; ``device=True`` keeps the result on device."""
    if update not in ("demix", "mix", "switching"):
        raise ValueError(f"unknown update mode {update!r}")
    X = _ensure(X)
    cdtype = np.dtype(dtype or DEFAULT_DTYPE)
    rdtype = real_dtype_of(cdtype)
    Xd = _to_device(X, cdtype)
    re, im, epochs = _ogive_batch_jit(
        Xd, jnp.asarray(step_size, rdtype), jnp.asarray(tol, rdtype),
        int(n_iter), model, update, int(switch_every), bool(init_eig),
        bool(proj_back),
    )
    Y = _from_jit(re, im, device)
    if return_epochs:
        return Y, np.asarray(epochs)
    return Y


@partial(jax.jit, static_argnames=("n_iter", "model", "proj_back"))
def _five_batch_jit(X, n_iter, model, proj_back):
    from .models.five import five_demix, five_iterations, five_whiten
    from .ops.projection import apply_projection_back

    def one(Xb):
        Xw, Q = five_whiten(Xb)
        F, M = Xw.shape[1], Xw.shape[2]
        w = jnp.zeros((F, M), Xw.dtype).at[:, 0].set(1.0)
        w = five_iterations(Xw, w, n_iter, model)
        Y = five_demix(Xw, w)[:, :, None]
        if proj_back:
            Y = apply_projection_back(Y, Xb[:, :, 0])
        return Y

    Y = jax.vmap(one)(X)
    return jnp.real(Y), jnp.imag(Y)


def five_batch(X, n_iter=10, proj_back=True, model="laplace", dtype=None,
               device=False):
    """Batch of same-shape mixtures through FIVE in ONE fused XLA program.

    X: (batch, T, F, M) -> (batch, T, F, 1). Accepts :func:`to_device`
    arrays; ``device=True`` keeps the result on device."""
    X = _ensure(X)
    Xd = _to_device(X, np.dtype(dtype or DEFAULT_DTYPE))
    re, im = _five_batch_jit(Xd, int(n_iter), model, bool(proj_back))
    return _from_jit(re, im, device)


@partial(
    jax.jit, static_argnames=("n_iter", "proj_back", "wcov")
)
def _ilrma_batch_jit(X, B0, H0, n_iter, proj_back, wcov):
    from .models.ilrma import ilrma_iterations
    from .ops.projection import apply_projection_back

    M = X.shape[3]

    def one(Xb, Bb, Hb):
        W = jnp.broadcast_to(jnp.eye(M, dtype=Xb.dtype), (Xb.shape[1], M, M))
        W, _, _ = ilrma_iterations(Xb, W, Bb, Hb, n_iter, wcov)
        Y = _core.demix(Xb, W)
        if proj_back:
            Y = apply_projection_back(Y, Xb[:, :, 0])
        return Y

    Y = jax.vmap(one)(X, B0, H0)
    return jnp.real(Y), jnp.imag(Y)


def ilrma_batch(
    X,
    n_src=None,
    n_iter=20,
    proj_back=True,
    n_components=2,
    seed=0,
    seeds=None,
    dtype=None,
    wcov="f32",
    device=False,
):
    """Batch of same-shape mixtures through ILRMA in ONE fused XLA program.

    X: (batch, T, F, M) -> (batch, T, F, M). Element b's NMF init matches
    ``ilrma(X[b], seed=seed + b)`` — or ``seed=seeds[b]`` when an explicit
    per-element ``seeds`` sequence is given (the sweep harness uses
    ``seeds=[s]*B`` to reproduce its single-instance runs exactly).
    Accepts :func:`to_device` arrays; ``device=True`` keeps the result on
    device."""
    X = _ensure(X)
    B, T, F, M = X.shape
    N = M if n_src is None else int(n_src)
    if N != M:
        raise ValueError("ilrma is determined: n_src must equal n_chan")
    if str(wcov) not in WCOV_MODES:
        raise ValueError(f"wcov must be one of {WCOV_MODES}, got {wcov!r}")
    cdtype = np.dtype(dtype or DEFAULT_DTYPE)
    rdtype = real_dtype_of(cdtype)
    if seeds is None:
        seeds = [seed + b for b in range(B)]
    if len(seeds) != B:
        raise ValueError(f"seeds must have batch length {B}")

    B0 = np.empty((B, N, F, n_components), rdtype)
    H0 = np.empty((B, N, n_components, T), rdtype)
    for b in range(B):
        rng = np.random.default_rng(seeds[b])
        B0[b] = (rng.random((N, F, n_components)) + 0.1).astype(rdtype)
        H0[b] = (rng.random((N, n_components, T)) + 0.1).astype(rdtype)

    Xd = _to_device(X, cdtype)
    re, im = _ilrma_batch_jit(
        Xd, jnp.asarray(B0), jnp.asarray(H0), int(n_iter), bool(proj_back),
        str(wcov),
    )
    return _from_jit(re, im, device)


@partial(
    jax.jit,
    static_argnames=("n_src", "n_iter", "model", "inner", "proj_back"),
)
def _auxiva_pca_batch_jit(X, n_src, n_iter, model, inner, proj_back):
    from .models.auxiva_iss import _iss_epoch
    from .models.overiva import overiva_run
    from .ops.projection import apply_projection_back

    M = X.shape[3]

    def one(Xb):
        Xr = _pca_mod.pca(Xb, n_src, False) if n_src < M else Xb
        if inner == "ip":
            Y, _ = overiva_run(Xr, n_src, n_iter, model)
        elif inner == "ip2":  # pairwise joint updates on the reduced dims
            from .models.overiva_ip2 import overiva_ip2_iterations

            W_hat, Cx = _prepare(Xr, Xr[:0], n_src, False, False, False)
            W_hat = overiva_ip2_iterations(Xr, W_hat, Cx, n_src, n_iter, model)
            Y = _core.demix(Xr, W_hat[:, :n_src, :])
        else:  # iss
            W = jnp.broadcast_to(
                jnp.eye(n_src, dtype=Xb.dtype), (Xb.shape[1], n_src, n_src)
            )
            Y0 = _core.demix(Xr, W)
            _, Y = jax.lax.fori_loop(
                0, n_iter, lambda _, s: _iss_epoch(Xr, s, model), (W, Y0)
            )
        if proj_back:
            # against the ORIGINAL mic 0, like the reference auxiva_pca
            Y = apply_projection_back(Y, Xb[:, :, 0])
        return Y

    Y = jax.vmap(one)(X)
    return jnp.real(Y), jnp.imag(Y)


def auxiva_pca_batch(
    X,
    n_src=None,
    n_iter=20,
    proj_back=True,
    model="laplace",
    inner="ip",
    dtype=None,
    device=False,
):
    """Batch of same-shape mixtures through PCA+AuxIVA in ONE fused XLA
    program. X: (batch, T, F, M) -> (batch, T, F, n_src); projection back
    is against the original mic 0 (see :func:`auxiva_pca`). Accepts
    :func:`to_device` arrays; ``device=True`` keeps the result on device."""
    X = _ensure(X)
    B, T, F, M = X.shape
    N = M if n_src is None else int(n_src)
    if not 1 <= N <= M:
        raise ValueError("need 1 <= n_src <= n_chan")
    if inner not in ("ip", "iss", "ip2"):
        raise ValueError(f"inner must be 'ip', 'iss' or 'ip2', got {inner!r}")
    if inner == "ip2" and N < 2:
        raise ValueError("inner='ip2' needs n_src >= 2")
    Xd = _to_device(X, np.dtype(dtype or DEFAULT_DTYPE))
    re, im = _auxiva_pca_batch_jit(
        Xd, N, int(n_iter), model, inner, bool(proj_back)
    )
    return _from_jit(re, im, device)
