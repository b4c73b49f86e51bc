"""On-card smoke test: the separation path on one NVIDIA GPU vs the oracle.

    python chip_smoke.py              # one GPU, every default phase
    python chip_smoke.py --devices 4  # four GPUs: the mesh path only

Drives the system the way a user does — ``serving.Separator`` and
``serving.StreamingSeparator`` on simulated rooms — at the WASPAA'19
configuration the repo is built around (M=8 mics, N=3 sources, nfft 4096
so F=2049 bins, 16 kHz, Laplace model, 30 epochs), and holds every output
to the float64 NumPy oracle (``overiva_jax.oracle``) run on the same
input. Phases, in order, each printing its measured deviation beside its
tolerance:

- device: refuses anything but a GPU (no CPU fallback);
- precision (c64): one epoch of the served spectral program per frequency
  bin against the oracle: median relative error <= 1e-5, which a float32
  contraction left to TF32 or bfloat16 would miss by two decades, and the
  worst (near-singular) bin within 3x of the worst bin of the NumPy oracle
  run in complex64 on the same input;
- clip (c64): ``separate`` on 5/8/11 s clips (three frame buckets),
  ``separate_batch`` on all three and the int16 PCM tiers, scored with
  ``bss_eval_sources`` against the oracle pipeline: |dSDR|, |dSIR| per
  source within max(0.1 dB, 2x the scene's own complex64 spread) — how far
  the oracle itself lands from its float64 run when it runs in complex64
  (see :func:`c64_spread`);
- stream (c64): ``StreamingSeparator("online-iss")`` against the oracle
  online ISS through the same STFT/iSTFT, max|err|/max|ref| <= 1e-3;
- df: the double-float ``acc="f32x2"`` tier against the f64 oracle, < 1e-5
  element-wise (checks that ``ops.df``'s FMA guard holds under the GPU's
  LLVM backend);
- c128: the clip phase again in complex128 (x64 switched on only here, so
  the phases before ran as users run them): max|err|/max|ref| <= 1e-6 and
  |dSDR|, |dSIR| <= 0.02 dB for ``separate`` and ``separate_batch``, and
  the int16 tiers within one output LSB of the oracle.

The warm per-clip and per-block latencies and the compile time are printed
for the record; they are not a benchmark. The last line of standard output
is one JSON object ``{"ok": true, "device": {...}}``; any failure exits
non-zero without printing it.

``--devices 4`` runs only the multi-device path: ``sharded_overiva`` on a
bins mesh against single-device ``api.overiva`` (c128, 1e-6 relative), and
``Separator(mesh=...).separate_batch`` on 8 clips against the meshless
path, asserting the outputs live on 4 distinct GPUs.

One process holds the card: JAX reserves most of its memory at start-up,
so a second JAX process on the same card fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

FS = 16000
NFFT, HOP = 4096, 2048
M, N, N_ITER = 8, 3, 30
CLIP_SECONDS = (5.0, 8.0, 11.0)
SEED = 1
TOL_DB_C128 = 0.02  # c128: same trajectory as the oracle
TOL_REL_C128 = 1e-6
# c64, one epoch, per-bin relative error: the median bin (3.4e-7 on the CPU
# backend at this shape, ~1e-3 for a TF32 or bf16 contraction), and the
# worst bin against the worst bin of the NumPy oracle run in complex64
TOL_BIN = 1e-5
BIN_WORST_FACTOR = 3.0
# c64 clips: the served output's |dSDR|, |dSIR| against the f64 oracle may
# reach max(TOL_DB_C64, C64_SPREAD_FACTOR * spread), spread being the
# scene's own complex64 sensitivity (c64_spread, C64_RUNS oracle runs)
TOL_DB_C64 = 0.1
C64_SPREAD_FACTOR = 2.0
C64_RUNS = 4
TOL_DF = 1e-5  # tests/test_overiva_df.py bound
# Streaming online ISS, c64 vs the f64 oracle: max|err|/max|ref| over the
# whole stream. The recursion forgets old blocks (0.97 per frame), so c64
# rounding (~6e-8 per op) does not accumulate; it is amplified only by the
# per-block rank-1 normalisations, to 2.7e-6 on the CPU backend and 3.8e-6
# on an H100 at this shape. 1e-3 (an error 60 dB below the signal) leaves
# room for another summation order while still catching any wrong update,
# which moves the output by O(1).
TOL_STREAM = 1e-3
# where every output must live; main() refuses to start anywhere else
PLATFORM = "gpu"


class SmokeFailure(RuntimeError):
    pass


def _say(msg: str) -> None:
    print(msg, flush=True)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


# ----------------------------------------------------------------- device


def _nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc.__class__.__name__})"
    return out.stdout.strip() or f"nvidia-smi rc={out.returncode}"


def phase_device(n_devices: int):
    import jax

    devs = jax.devices()
    platform = devs[0].platform
    if platform != PLATFORM:
        raise SmokeFailure(
            f"JAX found no GPU (platform {platform!r}); this smoke test runs "
            "only on the card and never falls back to the CPU"
        )
    _check(len(devs) >= n_devices,
           f"need {n_devices} GPUs, JAX sees {len(devs)}")
    from overiva_jax.sim._native import native_available

    card = _nvidia_smi()
    _say(f"[device] {card}")
    _say(f"[device] jax {jax.__version__}, {len(devs)} x "
         f"{devs[0].device_kind}, RIR engine "
         f"{'native' if native_available() else 'numpy'}")
    xla_env = {k: v for k, v in os.environ.items()
               if k.startswith("XLA_PYTHON_CLIENT_")}
    if xla_env:
        _say(f"[device] {xla_env}")
    return devs, card.splitlines()[0] if card else "unknown card"


# ------------------------------------------------------------- the scenes


def simulate(seconds: float, n_mics: int, n_src: int, seed: int):
    """Seeded shoebox scene: 7x6x3 m, RT60 0.25 s, SNR 25 dB, circular
    array of radius 5 cm. Returns (mix (n, M) float64, premix (K, M, n))."""
    from overiva_jax.sim import (
        ShoeBox,
        circular_mic_array,
        semi_circle_layout,
        speech_like,
    )

    n = int(round(seconds * FS))
    room = ShoeBox([7.0, 6.0, 3.0], fs=FS, rt60=0.25, seed=seed)
    for k, pos in enumerate(
        semi_circle_layout([3.5, 3.0, 1.5], np.pi / 2, 2.2, n_src,
                           rot=np.pi / 2)
    ):
        room.add_source(pos, speech_like(n, FS, seed=seed * 13 + k))
    room.add_mic_array(circular_mic_array([3.5, 3.0, 1.5], 0.05, n_mics))
    premix, noise = room.simulate(return_premix=True, snr=25.0)
    mix = (premix.sum(axis=0) + noise).T[:n]
    # headroom for the int16 tier: peak at half of full scale
    scale = 0.5 / np.abs(mix).max()
    return mix * scale, premix[:, :, :n] * scale


def oracle_separate(x, n_src, n_iter, nfft, hop):
    """Float64 NumPy pipeline: STFT -> overiva -> projection back -> iSTFT."""
    from overiva_jax import oracle

    X = oracle.analysis(oracle.stft_pad(x, nfft, hop), nfft, hop)
    Y = oracle.overiva(X, n_src=n_src, n_iter=n_iter, proj_back=True)
    return oracle.synthesis(Y, nfft, hop)[nfft - hop:][: x.shape[0]]


class _Scorer:
    """bss_eval against one clip's source images at mic 0."""

    def __init__(self, premix):
        from overiva_jax.metrics.bss_eval import BssEvalReferences

        self.refs = premix[:, 0, :]
        self.ev = BssEvalReferences(self.refs)

    def __call__(self, y):
        sdr, sir, _, _ = self.ev.evaluate(np.asarray(y, np.float64).T)
        return sdr, sir


def _db_delta(a, b):
    return max(float(np.max(np.abs(a[0] - b[0]))),
               float(np.max(np.abs(a[1] - b[1]))))


class _DeviceRecorder:
    """Wraps a jitted serving program to record the devices its output
    lives on, before ``Separator`` copies it to the host."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.devices: list[set] = []

    def __enter__(self):
        def wrapped(*a, **kw):
            out = self.fn(*a, **kw)
            self.devices.append(set(out.devices()))
            return out

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)
        return False


def _on_gpu(recorder, n_devices=1):
    _check(bool(recorder.devices), f"{recorder.name} never ran")
    for devs in recorder.devices:
        _check(all(d.platform == PLATFORM for d in devs),
               f"{recorder.name} output on {devs}, not the GPU")
        _check(len(devs) == n_devices,
               f"{recorder.name} output spans {len(devs)} devices, "
               f"expected {n_devices}")


# ------------------------------------------------------------ clip phase


def make_clips(seconds=CLIP_SECONDS, n_mics=M, n_src=N, seed=SEED):
    return [simulate(s, n_mics, n_src, seed + i)
            for i, s in enumerate(seconds)]


def c64_rounds(X, n_runs=C64_RUNS, seed=SEED):
    """The complex64 STFT of ``X`` and ``n_runs - 1`` re-roundings of it:
    each entry moved by a relative 2^-24 (half an ulp) complex Gaussian
    before the cast — equally valid complex64 versions of the same input."""
    rng = np.random.default_rng(seed)
    out = [X.astype(np.complex64)]
    for _ in range(n_runs - 1):
        d = rng.standard_normal(X.shape) + 1j * rng.standard_normal(X.shape)
        out.append((X * (1 + 2.0**-24 * d)).astype(np.complex64))
    return out


def c64_spread(x, score, s_ref, n_src=N, n_iter=N_ITER, nfft=NFFT, hop=HOP):
    """The scene's own complex64 sensitivity: the largest |dSDR|, |dSIR|
    (dB) of the NumPy oracle run in complex64 on the c64 roundings of the
    input, against its float64 run. On a 5 cm array the lowest bins are
    near-singular and the joint activations carry their rounding to every
    bin, so on some scenes every complex64 run lands tenths of a dB off
    the float64 trajectory; on others, hundredths."""
    from overiva_jax import oracle

    X = oracle.analysis(oracle.stft_pad(x, nfft, hop), nfft, hop)
    d = 0.0
    for Xc in c64_rounds(X):
        Y = oracle.overiva(Xc, n_src=n_src, n_iter=n_iter)
        y = oracle.synthesis(Y.astype(np.complex128), nfft, hop)
        d = max(d, _db_delta(score(y[nfft - hop:][: x.shape[0]]), s_ref))
    return d


def oracle_refs(clips, n_src=N, n_iter=N_ITER, nfft=NFFT, hop=HOP):
    """Per clip: its scorer, the f64 oracle's waveform and (SDR, SIR), and
    the clip's complex64 spread (:func:`c64_spread`)."""
    out = []
    for mix, premix in clips:
        score = _Scorer(premix)
        y_ref = oracle_separate(mix, n_src, n_iter, nfft, hop)
        s_ref = score(y_ref)
        spread = c64_spread(mix, score, s_ref, n_src, n_iter, nfft, hop)
        out.append(dict(score=score, y=y_ref, s=s_ref, spread=spread))
    return out


def tol_c64(spread):
    return max(TOL_DB_C64, C64_SPREAD_FACTOR * spread)


def phase_precision(sep, clip, nfft=NFFT, hop=HOP, tol=TOL_BIN,
                    worst_factor=BIN_WORST_FACTOR):
    """One epoch of ``sep``'s served spectral program (the clip program
    between STFT and iSTFT) in c64 against the f64 oracle on the same c64
    STFT, per frequency bin. Before the iteration has had time to amplify
    rounding, a correct float32 path is ~1e-7 off in a typical bin; a
    contraction left to TF32 or bfloat16 (~1e-3) shows in every bin. The
    near-singular lowest bins lose digits in any complex64 solve: there
    the worst bin is held to ``worst_factor`` times the worst bin of the
    NumPy oracle in complex64 over the c64 roundings (its einsums round
    in complex64; NumPy's LAPACK solves work in complex128 and round the
    result)."""
    import jax
    import jax.numpy as jnp

    from overiva_jax import oracle, serving

    mix, _ = clip
    cfg = dict(sep._fused_config(), n_iter=1)
    spectral = jax.jit(serving._spectral,
                       static_argnames=("n_src",) + tuple(cfg))
    X = oracle.analysis(oracle.stft_pad(mix, nfft, hop), nfft, hop)
    rounds = c64_rounds(X)
    Xc = rounds[0]
    R = oracle.overiva(Xc.astype(np.complex128), n_src=sep.n_src, n_iter=1)

    def per_bin(Y, R):
        return np.abs(Y - R).max(axis=(0, 2)) / np.abs(R).max(axis=(0, 2))

    Yd = spectral(jnp.asarray(Xc), n_src=sep.n_src, **cfg)
    _check(next(iter(Yd.devices())).platform == PLATFORM,
           "precision: spectral program did not run on the GPU")
    err = per_bin(np.asarray(Yd), R)
    np_worst = max(
        per_bin(oracle.overiva(Xr, n_src=sep.n_src, n_iter=1),
                oracle.overiva(Xr.astype(np.complex128), n_src=sep.n_src,
                               n_iter=1)).max()
        for Xr in rounds)
    med = float(np.median(err))
    worst = int(np.argmax(err))
    _say(f"[precision c64] served program 1 epoch, {mix.shape[0] / FS:g} s "
         f"clip: per-bin max|err|/max|ref| median {med:.3e} (tol {tol:g}); "
         f"worst bin {worst} at {err[worst]:.3e} (tol {worst_factor:g} x "
         f"NumPy-c64 worst {np_worst:.3e})")
    _check(med <= tol, f"precision: median per-bin error {med:.3e} > {tol:g}")
    _check(err[worst] <= worst_factor * np_worst,
           f"precision: worst bin {err[worst]:.3e} > {worst_factor:g} x "
           f"{np_worst:.3e}")


def phase_clip(clips, refs, card, dtype=np.complex64, n_src=N,
               n_iter=N_ITER, nfft=NFFT, hop=HOP):
    """``separate`` on each clip, ``separate_batch`` on all, and the int16
    PCM tiers, each scored against the f64 oracle.

    complex128: |dSDR|, |dSIR| <= 0.02 dB and max|err|/max|ref| <= 1e-6,
    and the int16 tiers within output quantisation of the oracle.
    complex64: |dSDR|, |dSIR| per source within :func:`tol_c64` of the
    clip's own complex64 spread, the int16 tier against the spread of its
    dequantised input. Returns the warm latencies (c64 only)."""
    from overiva_jax import serving

    c128 = np.dtype(dtype) == np.complex128
    label = "clip c128" if c128 else "clip c64"
    sep = serving.Separator("overiva", n_src=n_src, nfft=nfft, hop=hop,
                            n_iter=n_iter, dtype=dtype)
    rdt = sep._rdtype()
    if not c128:
        phase_precision(sep, clips[1], nfft, hop)

    def judge(what, y, ref):
        d = _db_delta(ref["score"](y), ref["s"])
        rel = float(np.abs(y - ref["y"]).max() / np.abs(ref["y"]).max())
        tol = TOL_DB_C128 if c128 else tol_c64(ref["spread"])
        spread = "" if c128 else f", c64 spread {ref['spread']:.4f} dB"
        _say(f"[{label}] {what}: max |dSDR|,|dSIR| {d:{'.2e' if c128 else '.4f'}} dB (tol "
             f"{tol:.4f}{spread}), max|err|/max|ref| {rel:.3e}"
             + (f" (tol {TOL_REL_C128:g})" if c128 else ""))
        _check(np.isfinite(y).all(), f"{label} {what}: non-finite output")
        _check(d <= tol, f"{label} {what}: {d:.4f} dB > {tol:.4f}")
        if c128:
            _check(rel <= TOL_REL_C128, f"{label} {what}: rel {rel:.3e}")

    t_first = {}
    with _DeviceRecorder(serving, "_serve_time_jit") as rec:
        for (mix, _), ref in zip(clips, refs):
            t0 = time.perf_counter()
            y = sep.separate(mix.astype(rdt))
            t_first[mix.shape[0]] = time.perf_counter() - t0
            _check(y.shape == (mix.shape[0], n_src),
                   f"{label}: separate gave {y.shape}")
            judge(f"separate {mix.shape[0] / FS:g} s, SDR "
                  f"{np.round(ref['s'][0], 2).tolist()} dB", y, ref)
    _on_gpu(rec)
    _check(sep.n_buckets() == len(clips),
           f"{label}: {sep.n_buckets()} buckets for {len(clips)} lengths")
    _say(f"[{label}] first call per bucket (compile included): "
         + ", ".join(f"{n / FS:g} s {t:.1f} s" for n, t in t_first.items()))

    with _DeviceRecorder(serving, "_serve_time_batch_jit") as rec:
        ys = sep.separate_batch([m.astype(rdt) for m, _ in clips])
    _on_gpu(rec)
    for (mix, _), y, ref in zip(clips, ys, refs):
        judge(f"separate_batch, {mix.shape[0] / FS:g} s", y, ref)

    # int16 in and int16 out, against the oracle on the same
    # (dequantised) input: agreement up to the output's quantisation
    mix = clips[1][0]
    sep_pcm = serving.Separator("overiva", n_src=n_src, nfft=nfft, hop=hop,
                                n_iter=n_iter, dtype=dtype,
                                out_dtype=np.int16)
    x16 = np.clip(np.round(mix * 32768), -32768, 32767).astype(np.int16)
    with _DeviceRecorder(serving, "_serve_time_jit") as rec:
        y16 = sep_pcm.separate(x16)
    _on_gpu(rec)
    _check(y16.dtype == np.int16, f"int16 tier returned {y16.dtype}")
    x_in = x16 / 32768.0
    score = refs[1]["score"]
    y_ref = oracle_separate(x_in, n_src, n_iter, nfft, hop)
    s_ref = score(y_ref)
    err = float(np.abs(y16 / 32768.0 - y_ref).max())
    d = _db_delta(score(y16 / 32768.0), s_ref)
    if c128:
        tol = TOL_REL_C128 * np.abs(y_ref).max() + 1.0 / 32768
        _say(f"[{label}] int16 in + int16 out, {mix.shape[0] / FS:g} s: "
             f"max |dSDR|,|dSIR| {d:.4f} dB, max|err| {err * 32768:.2f} LSB "
             f"(tol {tol * 32768:.2f} LSB)")
        _check(err <= tol, f"{label} int16: {err * 32768:.2f} LSB")
        return {}
    spread = c64_spread(x_in, score, s_ref, n_src, n_iter, nfft, hop)
    tol = tol_c64(spread)
    _say(f"[{label}] int16 in + int16 out, {mix.shape[0] / FS:g} s: "
         f"max |dSDR|,|dSIR| {d:.4f} dB (tol {tol:.4f}, c64 spread "
         f"{spread:.4f} dB), max|err| {err * 32768:.2f} LSB")
    _check(d <= tol, f"{label} int16: {d:.4f} dB > {tol:.4f}")

    x8 = clips[1][0].astype(rdt)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        sep.separate(x8)
        times.append(time.perf_counter() - t0)
    warm = float(np.median(times))
    _say(f"[latency] {card}: {x8.shape[0] / FS:g} s clip warm "
         f"{warm * 1e3:.1f} ms (median of 5), first call incl. compile "
         f"{t_first[x8.shape[0]]:.1f} s")
    return dict(warm_ms=warm * 1e3, first_s=t_first[x8.shape[0]])


# ----------------------------------------------------------- stream phase


def phase_stream(card, seconds=8.0, n_mics=4, nfft=512, block_frames=16,
                 tol=TOL_STREAM):
    from overiva_jax import oracle, serving

    hop = nfft // 2
    mix, _ = simulate(seconds, n_mics, 2, seed=SEED + 100)
    sep = serving.StreamingSeparator("online-iss", n_chan=n_mics, nfft=nfft,
                                     block_frames=block_frames)
    blk = sep.block_samples
    n_blocks = mix.shape[0] // blk
    x = mix[: n_blocks * blk].astype(np.float32)
    emits, times = [], []
    for i in range(n_blocks):
        t0 = time.perf_counter()
        emits.append(sep.process(x[i * blk:(i + 1) * blk]))
        times.append(time.perf_counter() - t0)
    y = np.concatenate(emits + [sep.flush()], axis=0)
    _check(next(iter(sep.carry.devices())).platform == PLATFORM,
           "stream state is not on the GPU")

    xp = np.concatenate([np.zeros((nfft - hop, n_mics)), x], axis=0)
    X = oracle.analysis(xp.astype(np.float64), nfft, hop)
    Y = oracle.online_iss_run(X, block_frames, forget=0.97)
    y_ref = oracle.synthesis(Y, nfft, hop)
    _check(y.shape == y_ref.shape, f"stream shape {y.shape} != {y_ref.shape}")
    rel = float(np.abs(y - y_ref).max() / np.abs(y_ref).max())
    _say(f"[stream c64] online-iss M={n_mics} nfft {nfft} "
         f"{block_frames}-frame blocks, {n_blocks} blocks: "
         f"max|err|/max|ref| {rel:.3e} (tol {tol:g})")
    _check(rel <= tol, f"stream: {rel:.3e} > {tol:g}")
    warm = float(np.median(times[1:]))
    _say(f"[latency] {card}: stream block ({blk / FS * 1e3:.0f} ms of audio) "
         f"warm {warm * 1e3:.2f} ms (median of {len(times) - 1}), first "
         f"block incl. compile {times[0]:.1f} s")
    return dict(block_ms=warm * 1e3)


# --------------------------------------------------------------- df phase


def phase_df(T=60, F=129, n_mics=4, n_src=2, n_iter=8, tol=TOL_DF):
    from overiva_jax import api, oracle

    rng = np.random.default_rng(SEED)
    S = rng.standard_normal((T, F, n_src)) + 1j * rng.standard_normal(
        (T, F, n_src))
    A = rng.standard_normal((F, n_mics, n_src)) + 1j * rng.standard_normal(
        (F, n_mics, n_src))
    X = np.einsum("fmn,tfn->tfm", A, S)
    X += 0.01 * (rng.standard_normal(X.shape)
                 + 1j * rng.standard_normal(X.shape))
    Xc = X.astype(np.complex64)
    Y = api.overiva(Xc, n_src=n_src, n_iter=n_iter, model="gauss",
                    acc="f32x2")
    Yo = oracle.overiva(Xc.astype(np.complex128), n_src=n_src,
                        n_iter=n_iter, model="gauss")
    rel = float(np.abs(Y - Yo).max() / np.abs(Yo).max())
    _say(f"[df] overiva gauss acc=f32x2 T={T} F={F} M={n_mics} N={n_src}: "
         f"max|err|/max|ref| {rel:.3e} (tol {tol:g})")
    _check(rel < tol, f"df: {rel:.3e} >= {tol:g}")


# ------------------------------------------------------------ mesh phase


def phase_mesh(n_devices, n_iter=20, nfft=NFFT, clip_seconds=5.0,
               tol=TOL_REL_C128):
    import jax
    import jax.numpy as jnp

    from overiva_jax import api, oracle, serving
    from overiva_jax.parallel.mesh import make_mesh
    from overiva_jax.parallel.sharded import sharded_overiva

    jax.config.update("jax_enable_x64", True)
    devs = jax.devices()[:n_devices]
    hop = nfft // 2
    mix, _ = simulate(6.0, M, N, seed=SEED + 200)
    X = oracle.analysis(oracle.stft_pad(mix, nfft, hop), nfft, hop)
    Y_single = api.overiva(X, n_src=N, n_iter=n_iter, dtype=np.complex128)
    Y_dev = sharded_overiva(make_mesh(1, n_devices, devices=devs),
                            jnp.asarray(X[None]), n_src=N, n_iter=n_iter)
    spans = Y_dev.sharding.device_set
    _check(len(spans) == n_devices and all(d.platform == PLATFORM
                                           for d in spans),
           f"sharded output spans {spans}")
    Y_shard = np.asarray(Y_dev)[0]
    rel = float(np.abs(Y_shard - Y_single).max() / np.abs(Y_single).max())
    _say(f"[mesh] sharded_overiva bins mesh 1x{n_devices}, F={X.shape[1]} "
         f"M={M} N={N} {n_iter} epochs c128: max|err|/max|ref| {rel:.3e} "
         f"(tol {tol:g}), output on {len(spans)} GPUs")
    _check(rel <= tol, f"mesh sharded_overiva: {rel:.3e} > {tol:g}")

    rng = np.random.default_rng(SEED)
    n0 = int(clip_seconds * FS)
    clips = [mix[: n0 - 97 * i] for i in range(8)]
    clips = [c + 1e-3 * rng.standard_normal(c.shape) for c in clips]
    sep_mesh = serving.Separator(
        "overiva", n_src=N, nfft=nfft, n_iter=n_iter, dtype=np.complex128,
        mesh=make_mesh(n_devices, 1, devices=devs))
    sep_ref = serving.Separator("overiva", n_src=N, nfft=nfft,
                                n_iter=n_iter, dtype=np.complex128)
    with _DeviceRecorder(serving, "_serve_time_batch_jit") as rec:
        outs = sep_mesh.separate_batch(clips)
    _on_gpu(rec, n_devices)
    refs = sep_ref.separate_batch(clips)
    worst = max(float(np.abs(o - r).max() / np.abs(r).max())
                for o, r in zip(outs, refs))
    _say(f"[mesh] Separator(mesh={n_devices}x1).separate_batch x{len(clips)} "
         f"c128 vs meshless: max|err|/max|ref| {worst:.3e} (tol {tol:g}), "
         f"output on {n_devices} GPUs")
    _check(worst <= tol, f"mesh serving: {worst:.3e} > {tol:g}")


# ------------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the multi-device mesh phase")
    args = ap.parse_args(argv)

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        import jax

        from overiva_jax.utils.cache import enable_persistent_cache
    except ImportError as exc:
        print(f"chip_smoke: cannot import the system ({exc})",
              file=sys.stderr)
        return 2

    try:
        devs, card = phase_device(args.devices)
        cache = enable_persistent_cache()
        _say(f"[device] compile cache at {cache}")
        t0 = time.perf_counter()
        if args.devices > 1:
            phase_mesh(args.devices)
        else:
            clips = make_clips()
            refs = oracle_refs(clips)
            _say(f"[setup] {len(clips)} scenes + f64 oracle in "
                 f"{time.perf_counter() - t0:.1f} s")
            phase_clip(clips, refs, card)
            phase_stream(card)
            phase_df()
            jax.config.update("jax_enable_x64", True)
            phase_clip(clips, refs, card, dtype=np.complex128)
        _say(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
