"""Serving tier: variable-length separation on a bounded set of XLA
executables (static-shape frame buckets + exact zero-frame padding).

XLA compiles one executable per input shape (tens of seconds for the
full-size programs); naive serving of arbitrary-length clips therefore
recompiles per clip length — unusable in production. The reference has no
serving story at all (``example.py`` separates one fixed file — SURVEY.md
§3.1); this module is added surface shaped by the static-shape constraint.

Design: pad the waveform so the STFT lands on a geometric grid of frame
counts (~``bucket_ratio``-spaced, so padding overhead is bounded by
``bucket_ratio - 1`` and the number of executables is logarithmic in the
clip-length range), zero every frame past the clip's own, and run the
algorithm on the bucketed tensor. The whole clip path is ONE fused XLA
program per (bucket, n_chan): STFT analysis, on-device zeroing of the
padded frames (the pad count ``t_pad`` is a TRACED scalar, so every clip
length within a bucket hits the same executable), the algorithm epochs,
projection back, and iSTFT. Only the real waveform crosses the host
boundary — once in, once out. Correctness rests on an algebraic property of the
IP/ISS family, not on approximation:

- an all-zero frame contributes nothing to any data statistic — the
  per-frame power and every weighted covariance carry an ``|x|^2``
  factor, so a huge padded-frame weight ``phi`` (the activation floor)
  multiplies zero;
- the only place the padded frame count enters is the ``1/T``
  normalization of ``Cx`` and the weighted covariances — a GLOBAL scalar
  per epoch. The IP normalizer ``w^H V w = 1`` re-pins every row's scale
  each epoch, so the padded trajectory stays a per-source scalar multiple
  of the unpadded one, and projection back (which rescales each source
  against the UNPADDED reference channel) cancels that scalar exactly.

Moving the frame zeroing inside the jit changes nothing in that
argument: the masked frames are exactly zero either way
(``tests/test_serving.py::test_padding_invariance`` gates the fused
program against the unpadded registry pipeline per family).

Padding is PREPENDED, which extends exactness to the tap-augmented joint
family (tiss/tip): delayed copies of leading zero frames are themselves
zero, and the first real frames' taps reach back into zeros exactly as
the unpadded run's zero-fill does. Appended padding would place real data
in the padded frames' tap blocks.

NMF-family algorithms (ilrma, ilrma-t, fastmnmf*) are NOT
padding-invariant — their multiplicative-update denominators sum model
terms over frames without an ``|x|^2`` factor, so zero frames shift the
updates — and sparseauxiva's LASSO threshold is scale-absolute.
``SERVABLE`` lists the algorithms whose invariance is gated by
``tests/test_serving.py``; anything else requires
``allow_unverified=True`` (results are then merely plausible, not
bit-matched to the unpadded run, and run through the slower
host-boundary path since they have no fused branch).
"""

from __future__ import annotations

import math
from collections import Counter
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from . import api
from .ops.covariance import WCOV_MODES
from .oracle.stft import stft_pad
from .parallel.mesh import AXIS_MIX
from .registry import ALGORITHMS, get_algorithm
from .utils.packing import real_dtype_of

__all__ = ["SERVABLE", "Separator", "StreamingSeparator", "bucket_frames"]

# Padding-invariance of every name here is asserted against the unpadded
# pipeline by tests/test_serving.py::test_padding_invariance. Keep the two
# lists in sync when adding a family.
SERVABLE = (
    "auxiva",
    "auxiva-gauss",
    "auxiva-iss",
    "auxiva-iss-gauss",
    "overiva",
    "overiva-gauss",
    "overiva-iss",
    "overiva-iss-gauss",
    "overiva-ip2",
    "overiva-ip2-gauss",
    "auxiva_pca",
    "auxiva_pca-iss",
    "five",
    # joint dereverberation+separation: exact because padding is
    # PREPENDED — delayed tap copies of leading zero frames are zero, and
    # the first real frames' taps reach into zeros exactly like the
    # unpadded run's zero-fill (ilrma-t stays out: NMF model)
    "tiss",
    "tiss-gauss",
    "tip",
    "tip-gauss",
)

# registry name -> (fused branch, default model). Every SERVABLE family has
# a branch in _spectral below; the two tables are asserted in sync by
# tests/test_serving.py. "pca" resolves to pca_ip / pca_iss from the
# ``inner`` kwarg at Separator construction.
_FUSED_BRANCH = {
    "auxiva": ("ip", "laplace"),
    "auxiva-gauss": ("ip", "gauss"),
    "auxiva-iss": ("iss", "laplace"),
    "auxiva-iss-gauss": ("iss", "gauss"),
    "overiva": ("ip", "laplace"),
    "overiva-gauss": ("ip", "gauss"),
    "overiva-iss": ("iss", "laplace"),
    "overiva-iss-gauss": ("iss", "gauss"),
    "overiva-ip2": ("ip2", "laplace"),
    "overiva-ip2-gauss": ("ip2", "gauss"),
    "auxiva_pca": ("pca", "laplace"),
    "auxiva_pca-iss": ("pca", "laplace"),
    "five": ("five", "laplace"),
    "tiss": ("tiss", "laplace"),
    "tiss-gauss": ("tiss", "gauss"),
    "tip": ("tip", "laplace"),
    "tip-gauss": ("tip", "gauss"),
}


def bucket_frames(
    n_frames: int,
    min_frames: int = 32,
    ratio: float = 1.25,
    multiple: int = 8,
) -> int:
    """Smallest grid frame count >= n_frames.

    The grid starts at ``min_frames`` (rounded up to ``multiple``) and
    grows geometrically by ``ratio`` — compute cost is linear in frames,
    so worst-case padding overhead is ``ratio - 1`` while the number of
    distinct compiled shapes stays logarithmic in the clip-length range.
    """
    if n_frames <= 0:
        raise ValueError("n_frames must be positive")
    b = -(-int(min_frames) // multiple) * multiple
    while b < n_frames:
        b = -(-int(max(b * ratio, b + multiple)) // multiple) * multiple
    return b


# ------------------------------------------------------- the fused program

def _spectral(X, n_src, n_iter, model, branch, taps, delay, warm_iter, wcov):
    """Masked STFT in -> projected sources out, trace-side.

    Each branch replicates its registry runner's exact trajectory (same
    init, same iteration kernels, same finalize) so the serving tier is
    bit-matched — modulo XLA fusion reassociation — to the host-boundary
    pipeline the invariance test compares against.
    """
    from .models.auxiva_iss import auxiva_iss_iterations
    from .models.auxiva_pca import pca as _pca_run
    from .models.five import five_demix, five_iterations, five_whiten
    from .models.overiva import demix, init_w_hat, overiva_iterations
    from .models.overiva_ip2 import overiva_ip2_iterations
    from .models.tip import tip_iterations
    from .models.tiss import augment_taps, augmented_eye, tiss_iterations
    from .ops.covariance import covariance
    from .ops.projection import apply_projection_back

    T, F, M = X.shape
    N = M if n_src is None else int(n_src)
    if branch in ("ip", "ip2"):
        # same init as api._prepare with W0=None, init_eig=False
        Cx = covariance(X) if N < M else jnp.zeros((F, M, M), X.dtype)
        W_hat = init_w_hat(X, N, False, Cx=Cx, W0=None)
        iterate = overiva_iterations if branch == "ip" else overiva_ip2_iterations
        W_hat = iterate(X, W_hat, Cx, N, n_iter, model, wcov=wcov)
        Y = demix(X, W_hat[:, :N, :])
    elif branch == "iss":
        W = jnp.broadcast_to(jnp.eye(M, dtype=X.dtype), (F, M, M))
        _, Y = auxiva_iss_iterations(X, W, n_iter, model, n_src=N)
        Y = Y[:, :, :N]
    elif branch in ("pca_ip", "pca_iss"):
        Xr = _pca_run(X, N) if N < M else X
        if branch == "pca_ip":
            Cz = jnp.zeros((F, N, N), X.dtype)
            W = init_w_hat(Xr, N, False, Cx=Cz, W0=None)
            W = overiva_iterations(Xr, W, Cz, N, n_iter, model)
            Y = demix(Xr, W[:, :N, :])
        else:
            W = jnp.broadcast_to(jnp.eye(N, dtype=X.dtype), (Xr.shape[1], N, N))
            _, Y = auxiva_iss_iterations(Xr, W, n_iter, model)
    elif branch == "five":
        Xw, _ = five_whiten(X)
        w = jnp.zeros((F, M), X.dtype).at[:, 0].set(1.0)
        w = five_iterations(Xw, w, n_iter, model)
        Y = five_demix(Xw, w)[:, :, None]
    elif branch in ("tiss", "tip"):
        Xt = augment_taps(X, taps, delay)
        P = augmented_eye(Xt, M)
        if branch == "tiss":
            P, Y = tiss_iterations(Xt, P, n_iter, model, M, n_src=N)
            Y = Y[:, :, :N]
        else:
            if warm_iter > 0 and taps > 0:  # api.tip's built-in warm start
                P, _ = tiss_iterations(Xt, P, warm_iter, model, M, n_src=N)
            P = tip_iterations(Xt, P, n_iter, model, M, n_src=N, wcov=wcov)
            Y = demix(Xt, P)[:, :, :N]
    else:
        raise ValueError(f"unknown fused branch {branch!r}")
    # projection back against the ORIGINAL (masked) reference channel —
    # this is what cancels the bucket-dependent covariance scale
    return apply_projection_back(Y, X[:, :, 0])


def _pcm16(y):
    """Quantize separated float samples to int16 PCM on device (the
    download half of the transfer tier): round-half-even at scale 32768
    with saturation — the same values a host-side wav writer produces,
    gated bit-exact in tests/test_serving.py."""
    return jnp.clip(
        jnp.round(y * jnp.asarray(32768.0, y.dtype)), -32768.0, 32767.0
    ).astype(jnp.int16)


def _masked_clip(x, t_pad, nfft, hop, cfg, rdt="float32", pcm_out=False):
    if jnp.issubdtype(x.dtype, jnp.integer):
        # int16 PCM transfer tier: the widening cast and the 2^-15 scale
        # are both EXACT in float, so this computes bit-identical values
        # to feeding x.astype(rdt) / 32768 — while moving HALF the bytes
        # to the device.
        x = x.astype(rdt) * jnp.asarray(1.0 / 32768.0, rdt)
    X = api._stft.analysis(x, nfft, hop)
    keep = jnp.arange(X.shape[0]) >= t_pad
    # the last prepended frames straddle the padding/real boundary (hop
    # overlap) — zero them so padded frames are EXACTLY zero, which is
    # what the invariance argument needs
    X = jnp.where(keep[:, None, None], X, jnp.zeros((), X.dtype))
    Y = _spectral(X, **cfg)
    y = api._stft.synthesis(Y, nfft, hop)
    return _pcm16(y) if pcm_out else y


_STATIC = (
    "nfft", "hop", "n_src", "n_iter", "model", "branch", "taps", "delay",
    "warm_iter", "wcov", "rdt", "pcm_out",
)


@partial(jax.jit, static_argnames=_STATIC)
def _serve_time_jit(x, t_pad, nfft, hop, n_src, n_iter, model, branch,
                    taps, delay, warm_iter, wcov, rdt="float32",
                    pcm_out=False):
    """(n_bucket_samples, M) real + traced pad count -> (n, n_out) real.

    ONE executable per (bucket, n_chan, config): analysis, frame zeroing,
    epochs, projection back, synthesis — zero host round-trips. int16
    input is scaled 1/32768 on device (exact; see _masked_clip).
    """
    cfg = dict(n_src=n_src, n_iter=n_iter, model=model, branch=branch,
               taps=taps, delay=delay, warm_iter=warm_iter, wcov=wcov)
    return _masked_clip(x, t_pad, nfft, hop, cfg, rdt, pcm_out)


@partial(jax.jit, static_argnames=_STATIC)
def _serve_time_batch_jit(x, t_pad, nfft, hop, n_src, n_iter, model, branch,
                          taps, delay, warm_iter, wcov, rdt="float32",
                          pcm_out=False):
    """(B, n_bucket_samples, M) + per-clip pad counts -> (B, n, n_out).

    vmap of the exact single-clip program, so batched results match the
    per-clip path element-wise (gated by tests/test_serving.py) while the
    whole bucket pays one dispatch.
    """
    cfg = dict(n_src=n_src, n_iter=n_iter, model=model, branch=branch,
               taps=taps, delay=delay, warm_iter=warm_iter, wcov=wcov)
    return jax.vmap(
        lambda xb, tp: _masked_clip(xb, tp, nfft, hop, cfg, rdt, pcm_out)
    )(x, t_pad)


_STREAM_STATIC = ("nfft", "hop", "algo", "model", "n_pass", "taps", "delay",
                  "tap_update")


@partial(jax.jit, static_argnames=_STREAM_STATIC)
def _stream_step_jit(x_blk, tail, carry, state, forget, pb_forget, tap_forget,
                     nfft, hop, algo, model, n_pass, taps, delay, tap_update):
    """One streaming block, fully fused: framing + analysis + online
    epoch(s) + synthesis + overlap-add, with every piece of state
    (demixing statistics, the nfft-hop input tail, the nfft-hop OLA
    carry) device-resident. Only real sample blocks cross the host
    boundary — the streaming analog of _serve_time_jit."""
    from .models.online_iss import online_iss_step
    from .models.online_tiss import online_tiss_step

    B_hop = x_blk.shape[0]  # block_frames * hop samples
    x = jnp.concatenate([tail, x_blk], axis=0)
    X = api._stft.analysis(x, nfft, hop)  # (block_frames, F, M)
    if algo == "online-iss":
        Y, state = online_iss_step(X, state, forget, model, n_pass,
                                   pb_forget=pb_forget)
    else:  # online-tiss
        Y, state = online_tiss_step(X, state, forget, taps, delay, model,
                                    n_pass, pb_forget=pb_forget,
                                    tap_update=tap_update,
                                    tap_forget=tap_forget)
    y = api._stft.synthesis(Y, nfft, hop)  # (B_hop + nfft - hop, M)
    emit = y[:B_hop].at[: nfft - hop].add(carry)
    new_carry = y[B_hop:]
    new_tail = x[B_hop:]
    return emit, new_tail, new_carry, state


class StreamingSeparator:
    """Streaming serving surface: time-domain sample blocks in, separated
    sample blocks out, ONE fused XLA executable per stream configuration.

    Wraps the online separation cores (``models/online_iss.py`` /
    ``models/online_tiss.py``) with device-resident STFT framing and
    weighted overlap-add, so a realtime caller never touches STFT frames
    and never pays more than one dispatch + two real sample transfers per
    block. The block shape is FIXED by construction (``block_frames *
    hop`` samples per call) — the static-shape story is what makes this a
    single warm executable, the same design constraint that shaped the
    bucketed clip path above (SURVEY.md §5.7; extension beyond the
    reference, which has no streaming surface).

        sep = StreamingSeparator("online-iss", n_chan=4, nfft=512)
        for blk in stream:              # (block_frames*hop, n_chan) float
            y = sep.process(blk)        # same shape out (M channels)

    Output is delayed by ``nfft - hop`` samples relative to the input
    (the overlap-add tail of each synthesis window is held back until the
    next block completes it); ``flush()`` drains that tail at stream end.
    The emitted samples equal running the STFT-domain online class over
    the same frames and synthesizing the concatenated stream
    (tests/test_serving.py::test_streaming_matches_offline_synthesis).

    ``algo``: "online-iss" (rank-1 streaming separation) or "online-tiss"
    (joint streaming dereverberation + separation; ``taps``/``delay``).
    """

    def __init__(self, algo="online-iss", n_chan=2, nfft=512, hop=None,
                 block_frames=8, forget=0.97, model="laplace", n_pass=1,
                 taps=4, delay=2, tap_update="solve", pb_forget=None,
                 tap_forget=None, dtype=None):
        from .models.online_iss import online_iss_init
        from .models.online_tiss import online_tiss_init

        if algo not in ("online-iss", "online-tiss"):
            raise ValueError(
                f"unknown streaming algo {algo!r}; use 'online-iss' or "
                "'online-tiss'"
            )
        self.algo = algo
        self.nfft = int(nfft)
        self.hop = int(hop or nfft // 2)
        self.block_frames = int(block_frames)
        self.n_chan = int(n_chan)
        self.block_samples = self.block_frames * self.hop
        if self.block_samples < self.nfft - self.hop:
            raise ValueError(
                "block_frames * hop must be >= nfft - hop (the emitted "
                "block must cover the overlap-add carry)"
            )
        cdtype = np.dtype(dtype or api.DEFAULT_DTYPE)
        rdtype = real_dtype_of(cdtype)
        self._rdtype = rdtype
        jdtype = jnp.complex64 if cdtype == np.complex64 else jnp.complex128
        F = self.nfft // 2 + 1
        if algo == "online-iss":
            self.state = online_iss_init(F, self.n_chan, jdtype)
            taps = 0
        else:
            self.state = online_tiss_init(F, self.n_chan, int(taps),
                                          int(delay), tap_update, jdtype)
        self._static = dict(
            nfft=self.nfft, hop=self.hop, algo=algo, model=str(model),
            n_pass=int(n_pass), taps=int(taps), delay=int(delay),
            tap_update=str(tap_update),
        )
        self.forget = jnp.asarray(forget, rdtype)
        self.pb_forget = (
            self.forget if pb_forget is None else jnp.asarray(pb_forget, rdtype)
        )
        self.tap_forget = (
            self.forget if tap_forget is None else jnp.asarray(tap_forget, rdtype)
        )
        # tail primed with zeros = the stft_pad front padding, so frame 0
        # of the stream matches frame 0 of the offline pipeline
        self.tail = jnp.zeros((self.nfft - self.hop, self.n_chan), rdtype)
        self.carry = jnp.zeros((self.nfft - self.hop, self.n_chan), rdtype)

    def process(self, x_blk: np.ndarray) -> np.ndarray:
        """(block_frames*hop, n_chan) float -> same-shape separated block
        (delayed by nfft - hop samples; see class docstring)."""
        x_blk = np.asarray(x_blk)
        if x_blk.shape != (self.block_samples, self.n_chan):
            raise ValueError(
                f"block must be ({self.block_samples}, {self.n_chan}) "
                f"(block_frames*hop samples), got {x_blk.shape}"
            )
        emit, self.tail, self.carry, self.state = _stream_step_jit(
            jnp.asarray(x_blk.astype(self._rdtype)), self.tail, self.carry,
            self.state, self.forget, self.pb_forget, self.tap_forget,
            **self._static,
        )
        return np.asarray(emit)

    def flush(self) -> np.ndarray:
        """Drain the held-back OLA tail (nfft - hop samples) at stream end."""
        out = np.asarray(self.carry)
        self.carry = jnp.zeros_like(self.carry)
        return out

    def warmup(self) -> None:
        """Compile and first-execute the block program WITHOUT disturbing
        stream state, so the first real block doesn't pay the compile
        (~seconds) inside its latency budget. Safe mid-stream too: state
        is snapshotted and restored around the throwaway zero block."""
        snap = (self.state, self.tail, self.carry)
        self.process(np.zeros((self.block_samples, self.n_chan),
                              self._rdtype))
        self.state, self.tail, self.carry = snap

    def save(self, path, **meta):
        """Persist the full stream state (core statistics + framing tail +
        OLA carry) to ``path`` (npz) — the streaming analog of the batch
        (return_filters, W0) checkpoint pair (SURVEY.md §5.4). Returns
        the written path."""
        from .api import _to_host
        from .utils.checkpoint import save_state

        host = {
            k: (_to_host(v) if jnp.iscomplexobj(v) else np.asarray(v))
            for k, v in self.state.items()
        }
        for k, v in (("tail", self.tail), ("carry", self.carry)):
            if k in host:
                raise ValueError(f"core state already has a {k!r} key")
            host[k] = np.asarray(v)
        meta.setdefault("class", type(self).__name__)
        meta.setdefault("algo", self.algo)
        return save_state(path, host, **meta)

    def restore(self, path) -> dict:
        """Resume a stream saved by :meth:`save` (shapes must match the
        constructor configuration). Returns the checkpoint metadata."""
        from .api import _to_device
        from .utils.checkpoint import load_state

        host, meta = load_state(path)
        expect = set(self.state) | {"tail", "carry"}
        if set(host) != expect:
            raise ValueError(
                f"checkpoint keys {sorted(host)} != stream keys "
                f"{sorted(expect)}"
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
        for k, cur in (("tail", self.tail), ("carry", self.carry)):
            if tuple(host[k].shape) != tuple(cur.shape):
                raise ValueError(
                    f"{k}: checkpoint shape {host[k].shape} != "
                    f"configured {tuple(cur.shape)}"
                )
        self.state = new
        self.tail = jnp.asarray(np.asarray(host["tail"], self._rdtype))
        self.carry = jnp.asarray(np.asarray(host["carry"], self._rdtype))
        return meta


class Separator:
    """Fixed-configuration separator for variable-length clips.

    One instance = one algorithm + STFT configuration; every clip routed
    through it reuses the per-bucket executables that jit already cached
    (the bucket grid is what makes the cache finite).

        sep = Separator("overiva", n_src=2, nfft=2048)
        y = sep.separate(x)          # x: (n_samples, n_chan) float
        # y: (n_samples, n_src) — same samples the unpadded pipeline yields

    ``algo_kwargs`` are forwarded to the algorithm on every clip (n_iter,
    model, wcov, ...). ``proj_back=False`` is rejected: projection back is
    what cancels the bucket-dependent global scale (module docstring) —
    without it outputs would differ from the unpadded run by a per-source
    scalar.

    Every SERVABLE family runs as ONE fused samples-to-samples XLA program
    per (bucket, n_chan) — the pad count is a traced argument, so all clip
    lengths within a bucket share the executable, and only real waveforms
    cross the host boundary. Transfer tiers: int16 PCM INPUT transfers as
    int16 and is scaled 1/32768 on device, bit-identical to the float
    path; ``out_dtype=np.int16`` quantizes the OUTPUT to int16 PCM on
    device (round-half-even at 32768, saturating) — what a wav writer
    would do on the host, at half the download bytes. Kwargs outside the fused program's static
    surface (callback, W0, return_filters, chunk_frames, acc, ...) and
    ``allow_unverified`` algorithms fall back to a host-boundary path that
    routes through the registry runner (several extra transfers per clip).

    ``mesh``: a ``('mix', 'bins')`` device mesh (``parallel.mesh.make_mesh``)
    scales ``separate_batch`` over chips — each bucket group's batch axis is
    sharded over the mesh's 'mix' axis (clips are independent, so XLA's SPMD
    partitioner runs one lane's program per chip with ZERO collectives; the
    group is padded to a multiple of the axis size by replicating its last
    clip, and the pad lanes are dropped on the way out). Per-clip results
    are gated equal to the meshless path (tests/test_serving.py). Requires
    a fused branch; ``separate()`` (a single clip) is unaffected.
    """

    # kwargs each fused branch accepts (beyond n_iter/model, always taken)
    _BRANCH_KW = {
        "ip": {"wcov"},
        "ip2": {"wcov"},
        "iss": set(),
        "pca_ip": set(),
        "pca_iss": set(),
        "five": set(),
        "tiss": {"taps", "delay"},
        "tip": {"taps", "delay", "warm_iter", "wcov"},
    }

    def __init__(
        self,
        algo: str = "overiva",
        n_src: int | None = None,
        nfft: int = 2048,
        hop: int | None = None,
        dtype=None,
        min_frames: int = 32,
        bucket_ratio: float = 1.25,
        bucket_multiple: int = 8,
        allow_unverified: bool = False,
        out_dtype=None,
        mesh=None,
        **algo_kwargs,
    ):
        self.spec = get_algorithm(algo)
        if algo not in SERVABLE and not allow_unverified:
            raise ValueError(
                f"algorithm {algo!r} is not verified padding-invariant "
                f"(servable: {', '.join(SERVABLE)}); NMF-family updates "
                "change under zero-frame padding. Pass "
                "allow_unverified=True to serve it anyway."
            )
        wcov = algo_kwargs.get("wcov", "f32")
        if str(wcov) not in WCOV_MODES:
            raise ValueError(f"wcov must be one of {WCOV_MODES}, got {wcov!r}")
        if algo_kwargs.get("proj_back") is False:
            raise ValueError(
                "serving requires proj_back=True: projection back cancels "
                "the bucket-dependent covariance scale (see module docstring)"
            )
        if self.spec.single_output and n_src not in (None, 1):
            raise ValueError(f"{algo!r} always extracts one source")
        if out_dtype is not None and np.dtype(out_dtype) != np.int16:
            raise ValueError(
                f"out_dtype must be None (float) or int16, got {out_dtype!r}"
            )
        self.algo = algo
        self.n_src = n_src
        self.nfft = int(nfft)
        self.hop = int(hop or nfft // 2)
        self.dtype = dtype
        self.pcm_out = out_dtype is not None
        self.min_frames = int(min_frames)
        self.bucket_ratio = float(bucket_ratio)
        self.bucket_multiple = int(bucket_multiple)
        self.algo_kwargs = dict(algo_kwargs)
        self._fused = self._fused_config()
        if mesh is not None:
            if self._fused is None:
                raise ValueError(
                    "mesh serving requires a fused branch: "
                    f"{algo!r} with these kwargs falls back to the "
                    "host-boundary path (no batch axis to shard)"
                )
            if AXIS_MIX not in mesh.shape:
                raise ValueError(
                    f"mesh must carry a {AXIS_MIX!r} axis "
                    "(parallel.mesh.make_mesh)"
                )
            if mesh.size != mesh.shape[AXIS_MIX]:
                import warnings

                warnings.warn(
                    "serving shards ONLY the batch axis over "
                    f"{AXIS_MIX!r}: this mesh has {mesh.size} devices but "
                    f"{AXIS_MIX}={mesh.shape[AXIS_MIX]}, so the other "
                    f"axes replicate every clip's compute "
                    f"{mesh.size // mesh.shape[AXIS_MIX]}x for no "
                    "throughput — use make_mesh(n_devices, 1)",
                    stacklevel=2,
                )
        self.mesh = mesh
        self.stats = {
            "clips": 0,
            "frames_real": 0,
            "frames_padded": 0,
            "bucket_hits": Counter(),
        }

    def _fused_config(self) -> dict | None:
        """Static config for the fused program, or None -> host fallback."""
        ent = _FUSED_BRANCH.get(self.algo)
        if ent is None:
            return None
        branch, model = ent
        params = {**self.spec.defaults, **self.algo_kwargs}
        params.pop("proj_back", None)  # always True here (checked above)
        if branch == "pca":
            inner = params.pop("inner", "ip")
            if inner not in ("ip", "iss"):
                return None
            branch = f"pca_{inner}"
        allowed = self._BRANCH_KW[branch]
        cfg = dict(
            branch=branch,
            model=str(params.pop("model", model)),
            n_iter=int(params.pop("n_iter", 20)),
            taps=int(params.pop("taps", 0)) if "taps" in allowed else 0,
            delay=int(params.pop("delay", 2)) if "delay" in allowed else 2,
            warm_iter=(
                int(params.pop("warm_iter", 0)) if "warm_iter" in allowed else 0
            ),
            wcov=str(params.pop("wcov", "f32")) if "wcov" in allowed else "f32",
        )
        if params:  # kwargs outside the fused static surface -> host path
            return None
        return cfg

    @property
    def fused(self) -> bool:
        """Whether clips run through the one-program device-resident path."""
        return self._fused is not None

    # -- bucket plumbing ---------------------------------------------------

    def _bucket(self, n_frames: int) -> int:
        return bucket_frames(
            n_frames, self.min_frames, self.bucket_ratio, self.bucket_multiple
        )

    def n_buckets(self) -> int:
        """Distinct (frame-bucket, n_chan) shapes seen so far."""
        return len(self.stats["bucket_hits"])

    def _rdtype(self):
        return real_dtype_of(np.dtype(self.dtype or api.DEFAULT_DTYPE))

    def _prep_clip(self, x: np.ndarray):
        """(samples, M) -> (padded xp, t_real, t_bucket, t_pad, n_bucket)."""
        xp = stft_pad(x, self.nfft, self.hop)  # front zeros + completion
        t_real = (xp.shape[0] - self.nfft) // self.hop + 1
        t_bucket = self._bucket(t_real)
        t_pad = t_bucket - t_real
        # padding goes at the FRONT (module docstring: tap exactness). The
        # +hop-1 tail fixes the per-bucket sample count when hop does not
        # divide nfft (analysis ignores samples past the last frame).
        n_bucket = (t_bucket - 1) * self.hop + self.nfft + (self.hop - 1)
        return xp, t_real, t_bucket, t_pad, n_bucket

    def _count(self, t_real: int, t_pad: int, n_chan: int) -> None:
        self.stats["clips"] += 1
        self.stats["frames_real"] += t_real
        self.stats["frames_padded"] += t_pad
        self.stats["bucket_hits"][(t_pad + t_real, n_chan)] += 1

    # -- the clip path -----------------------------------------------------

    def separate(self, x: np.ndarray) -> np.ndarray:
        """(n_samples, n_chan) float -> (n_samples, n_out) float.

        Output samples match the unpadded pipeline
        ``stft_synthesis(algo(stft_analysis(stft_pad(x))))`` trimmed back
        to the input span (tests/test_serving.py gates this per algorithm).
        """
        x = np.asarray(x)
        if x.ndim == 1:
            x = x[:, None]
        if x.ndim != 2:
            raise ValueError(f"expected (n_samples, n_chan), got {x.shape}")
        n, n_chan = x.shape
        int_in = x.dtype == np.int16
        if int_in and self._fused is None:
            # host fallback has no on-device cast stage — convert here
            x = x.astype(self._rdtype()) / np.asarray(32768, self._rdtype())
            int_in = False
        xp, t_real, t_bucket, t_pad, n_bucket = self._prep_clip(x)
        if self._fused is None:
            y = self._separate_host(xp, t_pad, t_bucket, n_bucket, n_chan)
        else:
            # int16 PCM clips transfer AS int16 (half the bytes) and are
            # scaled 1/32768 on device, bit-identical to x.astype(float)/32768 (exact cast
            # + power-of-two scale; gated in tests/test_serving.py)
            bdt = np.int16 if int_in else self._rdtype()
            xb = np.zeros((n_bucket, n_chan), dtype=bdt)
            xb[t_pad * self.hop : t_pad * self.hop + xp.shape[0]] = xp
            y = np.asarray(
                _serve_time_jit(
                    jnp.asarray(xb), jnp.asarray(np.int32(t_pad)),
                    nfft=self.nfft, hop=self.hop, n_src=self.n_src,
                    rdt=np.dtype(self._rdtype()).name,
                    pcm_out=self.pcm_out, **self._fused,
                )
            )
        if y.ndim == 1:
            y = y[:, None]
        self._count(t_real, t_pad, n_chan)
        start = t_pad * self.hop + (self.nfft - self.hop)
        return y[start : start + n]

    def _separate_host(self, xp, t_pad, t_bucket, n_bucket, n_chan):
        """Host-boundary fallback (allow_unverified algorithms / kwargs the
        fused program cannot take): explicit post-analysis frame zeroing,
        registry runner in the middle — several transfers per clip."""
        xb = np.zeros((n_bucket, n_chan), dtype=xp.dtype)
        xb[t_pad * self.hop : t_pad * self.hop + xp.shape[0]] = xp
        X = api.stft_analysis(xb, self.nfft, self.hop, dtype=self.dtype)
        X[:t_pad] = 0.0
        kw = dict(self.algo_kwargs)
        if self.dtype is not None:
            kw.setdefault("dtype", self.dtype)
        Y = self.spec(X, n_src=self.n_src, **kw)
        if isinstance(Y, tuple):  # return_filters=True passthrough
            Y = Y[0]
        if Y.ndim == 2:  # single-output extractors return (T, F)
            Y = Y[:, :, None]
        y = api.stft_synthesis(Y, self.nfft, self.hop, dtype=self.dtype)
        return self._pcm16_host(y) if self.pcm_out else y

    def separate_batch(self, clips) -> list[np.ndarray]:
        """Separate a sequence of clips, fusing same-bucket clips.

        Clips are grouped by (frame bucket, n_chan); each group runs as
        ONE fused XLA program (vmap of the identical single-clip program,
        per-clip traced pad counts), so a traffic mix of similar lengths
        pays one dispatch per bucket instead of one per clip. Returns
        outputs in input order. Without a fused branch, groups route
        through the family's registry ``run_batch``.
        """
        clips = [np.asarray(c) for c in clips]
        clips = [c[:, None] if c.ndim == 1 else c for c in clips]
        if self._fused is None:
            # host fallback has no on-device cast stage (see separate())
            rdtype = self._rdtype()
            clips = [
                c.astype(rdtype) / np.asarray(32768, rdtype)
                if c.dtype == np.int16 else c
                for c in clips
            ]
        hop = self.hop
        front = self.nfft - hop

        groups: dict[tuple[int, int], list[int]] = {}
        prepped = []
        for i, x in enumerate(clips):
            if x.ndim != 2:
                raise ValueError(f"clip {i}: expected (n_samples, n_chan)")
            xp, t_real, t_bucket, t_pad, n_bucket = self._prep_clip(x)
            prepped.append((xp, t_real, t_bucket, t_pad, n_bucket))
            groups.setdefault((t_bucket, x.shape[1]), []).append(i)

        out: list[np.ndarray | None] = [None] * len(clips)
        for (t_bucket, n_chan), idxs in groups.items():
            n_bucket = prepped[idxs[0]][4]
            if self._fused is None:
                ys = self._separate_batch_host(
                    [prepped[i] for i in idxs], t_bucket, n_bucket, n_chan
                )
            else:
                # all-int16 groups ride the int16 transfer tier; mixed
                # groups fall back to float with the exact host-side
                # 1/32768 scale on the int16 members
                rdtype = self._rdtype()
                all_i16 = all(
                    prepped[i][0].dtype == np.int16 for i in idxs
                )
                bdt = np.int16 if all_i16 else rdtype
                xb = np.zeros((len(idxs), n_bucket, n_chan), dtype=bdt)
                t_pads = np.empty((len(idxs),), np.int32)
                for b, i in enumerate(idxs):
                    xp, _, _, t_pad, _ = prepped[i]
                    if not all_i16 and xp.dtype == np.int16:
                        xp = xp.astype(rdtype) / np.asarray(32768, rdtype)
                    xb[b, t_pad * hop : t_pad * hop + xp.shape[0]] = xp
                    t_pads[b] = t_pad
                if self.mesh is not None:
                    xb_dev, tp_dev = self._shard_group(xb, t_pads)
                else:
                    xb_dev, tp_dev = jnp.asarray(xb), jnp.asarray(t_pads)
                ys_dev = _serve_time_batch_jit(
                    xb_dev, tp_dev,
                    nfft=self.nfft, hop=hop, n_src=self.n_src,
                    rdt=np.dtype(rdtype).name,
                    pcm_out=self.pcm_out, **self._fused,
                )
                if ys_dev.shape[0] != len(idxs):
                    # slice BEFORE the host fetch: an underfull mesh
                    # group's pad lanes are not copied to the host
                    ys_dev = ys_dev[: len(idxs)]
                ys = np.asarray(ys_dev)
                if ys.ndim == 2:
                    ys = ys[:, :, None]
            for b, i in enumerate(idxs):
                _, t_real, _, t_pad, _ = prepped[i]
                start = t_pad * hop + front
                n = clips[i].shape[0]
                out[i] = ys[b, start : start + n]
                self._count(t_real, t_pad, n_chan)
        return out

    def _separate_batch_host(self, group, t_bucket, n_bucket, n_chan):
        """Host-boundary batched fallback through the registry run_batch."""
        hop = self.hop
        kw = dict(self.algo_kwargs)
        if self.dtype is not None:
            kw.setdefault("dtype", self.dtype)
        xb = np.zeros(
            (len(group), n_bucket, n_chan),
            dtype=np.result_type(*(xp.dtype for xp, *_ in group)),
        )
        for b, (xp, _, _, t_pad, _) in enumerate(group):
            xb[b, t_pad * hop : t_pad * hop + xp.shape[0]] = xp
        X = api.stft_analysis_batch(xb, self.nfft, hop, dtype=self.dtype)
        for b, (_, t_real, _, _, _) in enumerate(group):
            X[b, : t_bucket - t_real] = 0.0
        Y = self.spec.run_batch(X, n_src=self.n_src, **kw)
        if Y.ndim == 3:  # single-output extractors return (B, T, F)
            Y = Y[:, :, :, None]
        ys = api.stft_synthesis_batch(Y, self.nfft, hop, dtype=self.dtype)
        return self._pcm16_host(ys) if self.pcm_out else ys

    def _shard_group(self, xb, t_pads):
        """Shard a bucket group's batch axis over the mesh 'mix' axis.

        Pads the group to a multiple of the axis size by replicating its
        last clip (real data keeps every lane's solves well-conditioned;
        the caller drops the pad lanes). Clips are independent, so the
        sharded program needs zero collectives — XLA runs one lane's
        program per chip.
        """
        from jax.sharding import NamedSharding, PartitionSpec

        n_lanes = self.mesh.shape[AXIS_MIX]
        pad = (-xb.shape[0]) % n_lanes
        if pad:
            xb = np.concatenate([xb, np.repeat(xb[-1:], pad, axis=0)])
            t_pads = np.concatenate([t_pads, np.repeat(t_pads[-1:], pad)])
        sh = NamedSharding(self.mesh, PartitionSpec(AXIS_MIX))
        return jax.device_put(xb, sh), jax.device_put(t_pads, sh)

    @staticmethod
    def _pcm16_host(y):
        # host twin of the fused program's _pcm16 (same rounding mode)
        rd = y.dtype
        return np.clip(
            np.round(y * rd.type(32768.0)), -32768.0, 32767.0
        ).astype(np.int16)

    def _t_real_of(self, n_samples: int) -> int:
        """Frame count the clip path produces for an ``n_samples`` clip."""
        xp_len = stft_pad(np.empty(n_samples), self.nfft, self.hop).shape[0]
        return (xp_len - self.nfft) // self.hop + 1

    def warmup(self, n_chan: int, n_samples: int, seed: int = 0,
               dtype=None) -> int:
        """Pre-compile every bucket needed up to ``n_samples``.

        Runs seeded noise clips through each grid bucket up to the one
        covering ``n_samples`` so first real traffic hits warm executables.
        Returns the number of buckets touched. ``dtype=np.int16``
        pre-compiles the int16 transfer-tier executables instead (each
        input dtype is its own executable).
        """
        rng = np.random.default_rng(seed)
        top = self._bucket(self._t_real_of(max(int(n_samples), self.nfft)))
        # walk clip lengths by a factor strictly below the bucket ratio so
        # no grid bucket is skipped; dedup by the bucket actually hit
        step = 1.0 + (self.bucket_ratio - 1.0) / 2.0
        n = self.nfft
        done: set[int] = set()
        while True:
            b = self._bucket(self._t_real_of(n))
            if b not in done:
                clip = rng.standard_normal((n, n_chan))
                if dtype is not None and np.dtype(dtype) == np.int16:
                    # clip before casting: |z| >= 4 sigma would overflow
                    # int16 (8192*4 = 32768), an undefined float->int cast
                    clip = np.clip(
                        np.round(clip * 8192), -32768, 32767
                    ).astype(np.int16)
                self.separate(clip)
                done.add(b)
            if b >= top:
                return len(done)
            n = int(math.ceil(n * step))
