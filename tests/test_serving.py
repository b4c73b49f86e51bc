"""Serving tier (overiva_jax/serving.py): static-shape frame buckets.

The load-bearing test is ``test_padding_invariance``: for every algorithm
in ``SERVABLE``, the bucketed clip path (zero-frame padding to a grid
shape) must reproduce the unpadded pipeline's samples — this is the
algebraic claim in the module docstring, gated per family. NMF-family
algorithms are genuinely NOT invariant and must be refused by default.
"""

from __future__ import annotations

import numpy as np
import pytest
from helpers import make_mixture

from overiva_jax import api
from overiva_jax.oracle.stft import stft_pad
from overiva_jax.serving import SERVABLE, Separator, bucket_frames

NFFT, HOP = 128, 64
CDT = np.complex128


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_after_module():
    """Free this module's ~40 cached executables (17 families x shapes,
    c128) when it finishes: with them retained, a later module's XLA CPU
    compile segfaulted deterministically in jaxlib
    (backend_compile_and_load inside test_tip.py::test_jax_parity_c128 —
    same bug family as the conftest cache note; 128 GB free, so state
    accumulation, not memory pressure)."""
    yield
    import jax

    jax.clear_caches()


def _unpadded(spec, x, n_src, **kw):
    """The reference clip pipeline: stft_pad -> analyze -> algo -> synth."""
    xp = stft_pad(x, NFFT, HOP)
    X = api.stft_analysis(xp, NFFT, HOP, dtype=CDT)
    Y = spec(X, n_src=n_src, **kw)
    if Y.ndim == 2:
        Y = Y[:, :, None]
    y = api.stft_synthesis(Y, NFFT, HOP, dtype=CDT)
    if y.ndim == 1:
        y = y[:, None]
    front = NFFT - HOP
    return y[front : front + x.shape[0]]


def _n_src_for(spec):
    if spec.determined or spec.single_output:
        return None
    return 2


@pytest.fixture(scope="module")
def mixture():
    rng = np.random.default_rng(7)
    mix, _, _ = make_mixture(rng, n_src=2, n_mics=3, n_samples=4000)
    return mix


@pytest.mark.parametrize("algo", SERVABLE)
def test_padding_invariance(algo, mixture):
    from overiva_jax.registry import get_algorithm

    spec = get_algorithm(algo)
    n_src = _n_src_for(spec)
    kw = {"n_iter": 6, "dtype": CDT}
    sep = Separator(algo, n_src=n_src, nfft=NFFT, hop=HOP, n_iter=6, dtype=CDT)
    got = sep.separate(mixture)
    # the bucket must actually pad — otherwise the test proves nothing
    assert sep.stats["frames_padded"] > 0
    want = _unpadded(spec, mixture, n_src, **kw)
    assert got.shape == want.shape
    scale = np.max(np.abs(want))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8 * scale)


@pytest.mark.parametrize("algo", ["overiva", "tiss"])
def test_padding_invariance_quarter_hop(algo, mixture):
    """The invariance argument is hop-independent (the pad is t_pad*hop
    samples, tap delays count frames): gate it at hop = nfft/4 too —
    every other serving test runs the half-hop default. (Non-dividing
    hops are rejected upstream by the biorthogonal synthesis window.)"""
    from overiva_jax.registry import get_algorithm

    hop = NFFT // 4
    spec = get_algorithm(algo)
    kw = {"n_iter": 4, "dtype": CDT}
    if algo == "tiss":
        kw.update(taps=2, delay=1)
    sep = Separator(algo, n_src=2, nfft=NFFT, hop=hop, **kw)
    got = sep.separate(mixture)
    assert sep.stats["frames_padded"] > 0
    xp = stft_pad(mixture, NFFT, hop)
    X = api.stft_analysis(xp, NFFT, hop, dtype=CDT)
    Y = spec(X, n_src=2, **kw)
    y = api.stft_synthesis(Y, NFFT, hop, dtype=CDT)
    front = NFFT - hop
    want = y[front : front + mixture.shape[0]]
    scale = np.max(np.abs(want))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8 * scale)


def test_bucket_grid():
    # exact multiples, monotone, geometric growth, floor at min_frames
    assert bucket_frames(1) == 32
    assert bucket_frames(32) == 32
    assert bucket_frames(33) % 8 == 0
    prev = 0
    for t in range(1, 400):
        b = bucket_frames(t)
        assert b >= t and b % 8 == 0
        assert b >= prev
        prev = b
    # overhead bounded by the ratio (plus rounding to the multiple)
    assert bucket_frames(321) <= int(321 * 1.25) + 8


def test_bucket_reuse(mixture):
    sep = Separator("auxiva", nfft=NFFT, hop=HOP, dtype=CDT, n_iter=2)
    sep.separate(mixture[:3600])
    sep.separate(mixture[:3900])  # same bucket: executable reuse
    assert sep.n_buckets() == 1
    assert sep.stats["clips"] == 2
    sep.separate(mixture[:2000])  # smaller bucket
    assert sep.n_buckets() == 2


def test_separate_batch_matches_per_clip(mixture):
    sep = Separator("overiva", n_src=2, nfft=NFFT, hop=HOP, dtype=CDT, n_iter=4)
    clips = [mixture[:3600], mixture[:2000], mixture[:3900]]
    outs = sep.separate_batch(clips)  # 3600/3900 fuse into one bucket
    assert sep.n_buckets() == 2 and sep.stats["clips"] == 3
    ref = Separator("overiva", n_src=2, nfft=NFFT, hop=HOP, dtype=CDT, n_iter=4)
    for c, o in zip(clips, outs):
        assert o.shape == (c.shape[0], 2)
        np.testing.assert_allclose(o, ref.separate(c), rtol=1e-9, atol=1e-12)


def test_mesh_batch_serving_matches_meshless(mixture):
    """Separator(mesh=...): each bucket group's batch axis shards over the
    mesh 'mix' axis (clips are independent — zero collectives); per-clip
    outputs must equal the meshless path, including the pad-lane drop when
    a group does not fill the axis (here groups of 2 and 1 on a 4-lane
    axis)."""
    import jax

    from overiva_jax.parallel.mesh import make_mesh

    mesh = make_mesh(4, 1, devices=jax.devices()[:4])
    sep = Separator(
        "overiva", n_src=2, nfft=NFFT, hop=HOP, dtype=CDT, n_iter=4,
        mesh=mesh,
    )
    clips = [mixture[:3600], mixture[:2000], mixture[:3900]]
    outs = sep.separate_batch(clips)
    ref = Separator("overiva", n_src=2, nfft=NFFT, hop=HOP, dtype=CDT, n_iter=4)
    refs = ref.separate_batch(clips)
    assert sep.stats["clips"] == 3  # pad lanes are not counted as traffic
    for o, r in zip(outs, refs):
        assert o.shape == r.shape
        np.testing.assert_allclose(o, r, rtol=1e-7, atol=1e-10)


def test_mesh_serving_rejections(mixture):
    import jax
    from jax.sharding import Mesh

    from overiva_jax.parallel.mesh import make_mesh

    mesh = make_mesh(4, 1, devices=jax.devices()[:4])
    with pytest.raises(ValueError, match="fused branch"):
        Separator("ilrma", nfft=NFFT, hop=HOP, allow_unverified=True,
                  mesh=mesh)
    bad = Mesh(np.asarray(jax.devices()[:8]).reshape(8), ("clips",))
    with pytest.raises(ValueError, match="mix"):
        Separator("overiva", n_src=2, nfft=NFFT, hop=HOP, mesh=bad)
    # a mesh with devices on non-'mix' axes replicates serving compute
    # for no throughput — accepted (results stay correct) but warned
    with pytest.warns(UserWarning, match="replicate"):
        Separator("overiva", n_src=2, nfft=NFFT, hop=HOP,
                  mesh=make_mesh(4, 2, devices=jax.devices()[:8]))


def test_separate_batch_single_output(mixture):
    sep = Separator("five", nfft=NFFT, hop=HOP, dtype=CDT, n_iter=3)
    outs = sep.separate_batch([mixture[:3600], mixture[:3900]])
    assert all(o.shape == (n, 1) for o, n in zip(outs, (3600, 3900)))
    ref = Separator("five", nfft=NFFT, hop=HOP, dtype=CDT, n_iter=3)
    np.testing.assert_allclose(
        outs[0], ref.separate(mixture[:3600]), rtol=1e-9, atol=1e-12
    )


@pytest.mark.parametrize("algo", SERVABLE)
def test_servable_runs_fused(algo):
    """Every SERVABLE family must take the one-program device-resident
    path (traced pad count, zero host round-trips) — the serving tier's
    latency claim is structural, not best-effort."""
    from overiva_jax.registry import get_algorithm

    spec = get_algorithm(algo)
    sep = Separator(algo, n_src=_n_src_for(spec), nfft=NFFT, hop=HOP,
                    n_iter=2, dtype=CDT)
    assert sep.fused


def test_unsupported_kwargs_fall_back_to_host_path(mixture):
    """Kwargs outside the fused static surface (here: chunk_frames) must
    still serve correctly through the host-boundary fallback — and the
    result must still match the unpadded pipeline."""
    from overiva_jax.registry import get_algorithm

    sep = Separator("overiva", n_src=2, nfft=NFFT, hop=HOP, n_iter=4,
                    dtype=CDT, chunk_frames=16)
    assert not sep.fused
    got = sep.separate(mixture)
    want = _unpadded(get_algorithm("overiva"), mixture, 2, n_iter=4,
                     dtype=CDT, chunk_frames=16)
    scale = np.max(np.abs(want))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8 * scale)


def test_refuses_non_invariant_families():
    with pytest.raises(ValueError, match="not verified padding-invariant"):
        Separator("ilrma", nfft=NFFT)
    with pytest.raises(ValueError, match="proj_back"):
        Separator("overiva", nfft=NFFT, proj_back=False)


def test_allow_unverified_smoke(mixture):
    # NMF family still RUNS under the bucket path when explicitly allowed
    sep = Separator(
        "ilrma", nfft=NFFT, hop=HOP, dtype=CDT, n_iter=3,
        allow_unverified=True,
    )
    y = sep.separate(mixture)
    assert y.shape == (mixture.shape[0], 3)
    assert np.all(np.isfinite(y))


def test_mono_input_and_single_output(mixture):
    sep = Separator("five", nfft=NFFT, hop=HOP, dtype=CDT, n_iter=3)
    y = sep.separate(mixture)
    assert y.shape == (mixture.shape[0], 1)


def test_warmup(mixture):
    sep = Separator("auxiva", nfft=NFFT, hop=HOP, dtype=CDT, n_iter=2)
    touched = sep.warmup(n_chan=3, n_samples=4000)
    assert touched == sep.n_buckets() >= 2
    # a real clip after warmup lands in an already-seen bucket
    before = sep.n_buckets()
    sep.separate(mixture)
    assert sep.n_buckets() == before


@pytest.mark.parametrize("algo", ["online-iss", "online-tiss"])
def test_streaming_matches_offline_synthesis(algo, mixture):
    """StreamingSeparator (fused samples->samples blocks, device-resident
    OLA/tail/statistics state) must emit exactly what the STFT-domain
    online class + full offline synthesis of the same frames yields."""
    from overiva_jax.api import OnlineAuxIVAISS, OnlineTISS
    from overiva_jax.serving import StreamingSeparator

    nfft, hop, bf = NFFT, HOP, 8
    blk = bf * hop
    n_blocks = mixture.shape[0] // blk
    x = mixture[: n_blocks * blk]

    kw = dict(taps=2, delay=1) if algo == "online-tiss" else {}
    sep = StreamingSeparator(algo, n_chan=3, nfft=nfft, hop=hop,
                             block_frames=bf, forget=0.97, n_pass=2,
                             dtype=CDT, **kw)
    emits = [sep.process(x[i * blk : (i + 1) * blk]) for i in range(n_blocks)]
    y_stream = np.concatenate(emits + [sep.flush()], axis=0)

    xp = np.concatenate([np.zeros((nfft - hop, 3)), x], axis=0)
    X = api.stft_analysis(xp, nfft, hop, dtype=CDT)
    cls = OnlineAuxIVAISS if algo == "online-iss" else OnlineTISS
    ref = cls(n_freq=X.shape[1], n_chan=3, forget=0.97, n_pass=2,
              dtype=CDT, **kw)
    Y = np.concatenate(
        [ref.process(X[i * bf : (i + 1) * bf]) for i in range(n_blocks)],
        axis=0,
    )
    y_ref = api.stft_synthesis(Y, nfft, hop, dtype=CDT)

    assert y_stream.shape == y_ref.shape
    scale = max(np.max(np.abs(y_ref)), 1e-12)
    np.testing.assert_allclose(y_stream, y_ref, rtol=1e-8, atol=1e-10 * scale)


def test_streaming_warmup_and_checkpoint(mixture, tmp_path):
    """warmup() compiles without disturbing state; save()/restore()
    resumes the stream bit-identically (SURVEY.md §5.4 analog)."""
    from overiva_jax.serving import StreamingSeparator

    nfft, hop, bf = NFFT, HOP, 8
    blk = bf * hop
    x = mixture[: 4 * blk]

    def run(sep, lo, hi):
        return [sep.process(x[i * blk : (i + 1) * blk])
                for i in range(lo, hi)]

    ref = StreamingSeparator("online-iss", n_chan=3, nfft=nfft, hop=hop,
                             block_frames=bf, forget=0.97, dtype=CDT)
    ref_out = run(ref, 0, 4)

    # warmup mid-construction AND mid-stream must be a no-op on output
    sep = StreamingSeparator("online-iss", n_chan=3, nfft=nfft, hop=hop,
                             block_frames=bf, forget=0.97, dtype=CDT)
    sep.warmup()
    out_a = run(sep, 0, 2)
    sep.warmup()
    path = sep.save(tmp_path / "stream", note="midpoint")
    out_b = run(sep, 2, 4)
    for got, want in zip(out_a + out_b, ref_out):
        np.testing.assert_array_equal(got, want)

    # restore into a FRESH instance and replay the second half
    sep2 = StreamingSeparator("online-iss", n_chan=3, nfft=nfft, hop=hop,
                              block_frames=bf, forget=0.97, dtype=CDT)
    meta = sep2.restore(path)
    assert meta["note"] == "midpoint" and meta["algo"] == "online-iss"
    out_c = run(sep2, 2, 4)
    for got, want in zip(out_c, ref_out[2:]):
        np.testing.assert_array_equal(got, want)

    # shape-mismatched restore refuses
    bad = StreamingSeparator("online-iss", n_chan=2, nfft=nfft, hop=hop,
                             block_frames=bf, forget=0.97, dtype=CDT)
    with pytest.raises(ValueError):
        bad.restore(path)


def test_int16_transfer_tier_exact(mixture):
    """int16 PCM input is bit-identical to x.astype(float)/32768: the
    widening cast and the 2^-15 scale are exact, so the transfer tier
    (half the transfer bytes) changes no
    values. Mixed and all-int16 batches match the per-clip path."""
    from overiva_jax.serving import Separator

    sep = Separator("overiva", n_src=2, nfft=NFFT, hop=HOP, n_iter=4,
                    dtype=CDT)
    x_f = mixture[: 5 * NFFT].astype(np.float64)
    x_i = np.clip(np.round(x_f / np.abs(x_f).max() * 20000), -32768,
                  32767).astype(np.int16)
    rd = np.float32 if np.dtype(CDT) == np.complex64 else np.float64
    y_int = sep.separate(x_i)
    y_float = sep.separate(x_i.astype(rd) / rd(32768))
    np.testing.assert_array_equal(y_int, y_float)

    # all-int16 batch group == per-clip; mixed batch converts exactly
    clips_i = [x_i, x_i[: x_i.shape[0] - HOP]]
    outs = sep.separate_batch(clips_i)
    for c, o in zip(clips_i, outs):
        np.testing.assert_allclose(o, sep.separate(c), rtol=1e-9, atol=0)
    mixed = [x_i, (x_i[: x_i.shape[0] - HOP].astype(rd) / rd(32768))]
    outs_m = sep.separate_batch(mixed)
    np.testing.assert_allclose(outs_m[0], sep.separate(x_i), rtol=1e-9,
                               atol=0)
    np.testing.assert_allclose(outs_m[1], sep.separate(mixed[1]),
                               rtol=1e-9, atol=0)


def test_int16_output_tier(mixture):
    """out_dtype=np.int16 quantizes on device exactly as a host wav
    writer would (round-half-even at 32768, saturating), on both the
    fused and host-fallback paths."""
    from overiva_jax.serving import Separator

    x = mixture[: 5 * NFFT]
    kw = dict(n_src=2, nfft=NFFT, hop=HOP, n_iter=4, dtype=CDT)
    sep_f = Separator("overiva", **kw)
    sep_i = Separator("overiva", out_dtype=np.int16, **kw)
    y_f = sep_f.separate(x)
    y_i = sep_i.separate(x)
    assert y_i.dtype == np.int16
    want = np.clip(np.round(y_f * y_f.dtype.type(32768.0)),
                   -32768.0, 32767.0).astype(np.int16)
    np.testing.assert_array_equal(y_i, want)

    outs = sep_i.separate_batch([x, x[: x.shape[0] - HOP]])
    np.testing.assert_array_equal(outs[0], y_i)

    with pytest.raises(ValueError, match="out_dtype"):
        Separator("overiva", out_dtype=np.float16, **kw)
