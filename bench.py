"""Benchmark: OverIVA iteration throughput at the BASELINE config.

Headline metric (stable name/protocol for the driver): fused OverIVA
iterations/sec at M=8 mics, N=3 sources, 4096-pt STFT (F=2049 bins), T=128
frames, measured as 30 iterations per program execution including dispatch
overhead — the way a user-facing 30-iteration separation call runs.

Extra rows (in the same single JSON line under "extra"):
  - overiva_marginal_it_s: (t(230)-t(30))/200 marginal rate — per-iteration
    cost with the fixed per-call dispatch and wait cost cancelled
  - overiva_T512_it_s: the realistic frame count (SURVEY.md §3.2 puts
    T~300-700); same 30-iter protocol
  - auxiva_iss_it_s: the solve-free speed tier at the same M=8/F=2049
  - pca_iss_it_s: PCA to N=3 + ISS, the fast overdetermined path
  - tiss_T512_taps5_it_s: joint dereverb+separation (T-ISS) at T=512

Prints ONE JSON line: {"metric", "value", "unit", "device", "extra"}, with
the device as JAX reports it. Every timing waits for the device through
``jax.block_until_ready``.
"""

import json
import os
import sys
import time

import numpy as np

# Wall budget for the EXTRA rows: the headline row always runs, but once
# this much time has elapsed the remaining extras are skipped (noted in
# extra["bench_truncated_at"]) so the one JSON line is always printed.
BUDGET_S = float(os.environ.get("OVERIVA_BENCH_BUDGET_S", "2400"))
_T0 = time.perf_counter()


def _make_mix(rng, T, F, M):
    re = rng.standard_normal((T, F, M)).astype(np.float32)
    im = rng.standard_normal((T, F, M)).astype(np.float32)
    # speech-like temporal gating so activations are realistic
    gate = np.where(rng.random(T) < 0.5, 1.0, 0.1).astype(np.float32)
    return re * gate[:, None, None], im * gate[:, None, None]


def main():
    import jax
    import jax.numpy as jnp

    if jax.devices()[0].platform == "cpu":
        sys.exit("bench.py times the accelerator; JAX found only the CPU")

    from overiva_jax.api import _prepare
    from overiva_jax.models.auxiva_iss import auxiva_iss_iterations
    from overiva_jax.models.overiva import overiva_iterations
    from overiva_jax.utils.cache import enable_persistent_cache

    enable_persistent_cache()

    F, M, N = 2049, 8, 3
    N_ITER = 30

    def timed(thunk, repeats=3):
        out = jax.block_until_ready(thunk())  # warmup: compile
        best = np.inf
        for _ in range(repeats):
            t0 = time.perf_counter()
            out = jax.block_until_ready(thunk())
            best = min(best, time.perf_counter() - t0)
        return best, out

    def check_finite(W):
        re_w, im_w = jax.jit(lambda w: (w.real, w.imag))(W)
        assert (
            np.isfinite(np.asarray(re_w)).all()
            and np.isfinite(np.asarray(im_w)).all()
        ), "benchmark produced non-finite demixing filters"

    rng = np.random.default_rng(0)
    extra = {}

    # ---- headline: OverIVA-IP, T=128, 30 iters incl dispatch ----
    re, im = _make_mix(rng, 128, F, M)
    X = jax.jit(lambda r, i: r + 1j * i)(re, im)
    W0 = jax.jit(lambda x: x[:0])(X)
    W_hat, Cx = _prepare(X, W0, N, False, True, False)

    t30, W = timed(lambda: overiva_iterations(X, W_hat, Cx, N, N_ITER, "laplace"))
    check_finite(W)
    value = N_ITER / t30

    # Every row below is an EXTRA: a failure must not kill the headline
    # JSON line the driver records. Each row runs in its own guard so one
    # failing row (e.g. a backend quirk) cannot skip the rows after it;
    # failures are listed per-row in extra["bench_errors"]. A row whose
    # inputs were built by an earlier failed row reports a NameError.
    _errors = []

    class _Budget(Exception):
        pass

    class _row:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            if time.perf_counter() - _T0 > BUDGET_S:
                raise _Budget(self.name)
            return None

        def __exit__(self, et, ev, tb):
            if et is not None:
                _errors.append(f"{self.name}: {et.__name__}: {ev}"[:160])
            return True

    def _extra_rows():
        with _row("overiva_marginal_it_s"):
            # marginal rate: cancel the fixed per-execution dispatch and wait cost
            t230, W = timed(
                lambda: overiva_iterations(X, W_hat, Cx, N, 230, "laplace"), repeats=2
            )
            check_finite(W)
            extra["overiva_marginal_it_s"] = round(200 / (t230 - t30), 1)

        with _row("overiva_bf16_it_s"):
            # ---- bf16 weighted-covariance mode (wcov="bf16"; quality within
            # 0.3 dB of f32 on the integration mixtures — tests/test_bf16.py) ----
            t_bf, W = timed(
                lambda: overiva_iterations(X, W_hat, Cx, N, N_ITER, "laplace", wcov="bf16")
            )
            check_finite(W)
            extra["overiva_bf16_it_s"] = round(N_ITER / t_bf, 1)

        with _row("overiva_f32x3_it_s"):
            # ---- f32x3 tier (lax.Precision.HIGH; what it costs and how far it
            # moves V on this device: bench/exp_wcov_tiers.py) ----
            t_x3, W = timed(
                lambda: overiva_iterations(X, W_hat, Cx, N, N_ITER, "laplace", wcov="f32x3")
            )
            check_finite(W)
            extra["overiva_f32x3_it_s"] = round(N_ITER / t_x3, 1)

        with _row("overiva_T512"):
            # ---- realistic frame count T=512 ----
            re5, im5 = _make_mix(rng, 512, F, M)
            X5 = jax.jit(lambda r, i: r + 1j * i)(re5, im5)
            W05 = jax.jit(lambda x: x[:0])(X5)
            W_hat5, Cx5 = _prepare(X5, W05, N, False, True, False)
            t5, W = timed(lambda: overiva_iterations(X5, W_hat5, Cx5, N, N_ITER, "laplace"))
            check_finite(W)
            extra["overiva_T512_it_s"] = round(N_ITER / t5, 1)
            t5b, W = timed(
                lambda: overiva_iterations(X5, W_hat5, Cx5, N, N_ITER, "laplace", wcov="bf16")
            )
            check_finite(W)
            extra["overiva_T512_bf16_it_s"] = round(N_ITER / t5b, 1)
            t5x, W = timed(
                lambda: overiva_iterations(X5, W_hat5, Cx5, N, N_ITER, "laplace", wcov="f32x3")
            )
            check_finite(W)
            extra["overiva_T512_f32x3_it_s"] = round(N_ITER / t5x, 1)

        with _row("overiva_T512_marginal"):
            # ---- marginal T=512 epoch time, per-call dispatch cancelled ----
            t130, W = timed(
                lambda: overiva_iterations(X5, W_hat5, Cx5, N, 130, "laplace"),
                repeats=2,
            )
            check_finite(W)
            extra["overiva_T512_marginal_ms"] = round((t130 - t5) / 100.0 * 1e3, 3)

        with _row("overiva_df"):
            # ---- double-float certification tier (acc="f32x2",
            # models/overiva_df.py): full-precision parity run at the
            # hardware-probe shape — what emulated-f64 numerics cost ----
            from overiva_jax.models import overiva_df as _dfc

            T_df, F_df, M_df, N_df = 128, 513, 5, 2
            re_d, im_d = _make_mix(rng, T_df, F_df, M_df)
            one = np.float32(1.0)
            w0p = jnp.zeros((0,), jnp.float32)
            Wd, Cxd = _dfc.prepare_df(
                jnp.asarray(re_d), jnp.asarray(im_d), w0p, w0p, one,
                N_df, False,
            )
            t_df, hi_d = timed(
                lambda: _dfc.overiva_df_iterations(
                    jnp.asarray(re_d), jnp.asarray(im_d), Wd, Cxd, one,
                    N_df, 15, "gauss",
                )[0][0],
                repeats=2,
            )
            assert np.isfinite(np.asarray(hi_d)).all()
            extra["overiva_df15_M5_F513_ms"] = round(t_df * 1e3, 1)

        with _row("overiva_batch16"):
            # ---- batched serving throughput: 16 mixtures per fused program.
            # The sweep/serving fan-out path (api.overiva_batch): dispatch overhead
            # amortizes across the batch, so the per-mixture rate approaches the
            # marginal rate. ----
            B = 16
            reb = np.stack([_make_mix(rng, 128, F, M)[0] for _ in range(B)])
            imb = np.stack([_make_mix(rng, 128, F, M)[1] for _ in range(B)])
            Xb = jax.jit(lambda r, i: r + 1j * i)(reb, imb)
            prep_b = jax.jit(
                lambda xb: jax.vmap(lambda x: _prepare(x, x[:0], N, False, True, False))(xb)
            )
            W_hatb, Cxb = prep_b(Xb)
            run_b = jax.jit(
                lambda xb, wb, cb: jax.vmap(
                    lambda x, w, c: overiva_iterations(x, w, c, N, N_ITER, "laplace")
                )(xb, wb, cb)
            )
            t_b, Wb = timed(lambda: run_b(Xb, W_hatb, Cxb))
            check_finite(Wb)
            extra["overiva_batch16_it_s_per_mix"] = round(B * N_ITER / t_b, 1)

        with _row("serving_clip"):
            # ---- serving tier (overiva_jax/serving.py): warm end-to-end
            # clip latency — numpy waveform in -> separated waveform out
            # (STFT, 30 OverIVA iterations, projection back, iSTFT) through
            # the bucket grid at the headline config. rt_factor = audio
            # seconds separated per wall second on one device. ----
            from overiva_jax.serving import Separator

            fs = 16000
            sep = Separator("overiva", n_src=N, nfft=4096, hop=2048,
                            n_iter=N_ITER)
            rngs = np.random.default_rng(3)
            clip = rngs.standard_normal((8 * fs, M)).astype(np.float32)
            gate = np.repeat(
                np.where(rngs.random(clip.shape[0] // 160 + 1) < 0.5, 1.0, 0.1),
                160,
            )[: clip.shape[0]]
            clip *= gate[:, None].astype(np.float32)
            sep.separate(clip)  # compile
            best = np.inf
            for _ in range(6):
                t0 = time.perf_counter()
                y_s = sep.separate(clip)
                best = min(best, time.perf_counter() - t0)
            assert np.isfinite(y_s).all()
            extra["serving_warm_clip8s_ms"] = round(best * 1e3, 1)
            extra["serving_rt_factor"] = round(8.0 / best, 1)

            # int16 PCM transfer tiers: half the bytes each way. Input
            # side is bit-identical to the float path (exact cast + 2^-15
            # scale);
            # output side quantizes on device exactly as a host wav
            # writer would (tests/test_serving.py gates both).
            clip_i = np.clip(np.round(clip * 8192), -32768, 32767
                             ).astype(np.int16)
            sep_pcm = Separator("overiva", n_src=N, nfft=4096, hop=2048,
                                n_iter=N_ITER, out_dtype=np.int16)
            sep_pcm.separate(clip_i)  # compile the int16 io executable
            best_i = np.inf
            for _ in range(6):
                t0 = time.perf_counter()
                y_i = sep_pcm.separate(clip_i)
                best_i = min(best_i, time.perf_counter() - t0)
            assert y_i.dtype == np.int16 and np.abs(y_i).max() > 0
            extra["serving_warm_clip8s_pcm16_ms"] = round(best_i * 1e3, 1)

            # fused same-bucket batch: 8 clips, one dispatch (separate_batch)
            clips = [clip[: 8 * fs - i * 2048] for i in range(8)]
            sep.separate_batch(clips)  # compile the batched program
            t_sb = np.inf
            for _ in range(3):
                t0 = time.perf_counter()
                outs = sep.separate_batch(clips)
                t_sb = min(t_sb, time.perf_counter() - t0)
            assert all(np.isfinite(o).all() for o in outs)
            extra["serving_batch8_ms_per_clip"] = round(t_sb / 8 * 1e3, 1)

            # int16 both ways, batched: the realistic PCM throughput
            # configuration (half the transfer bytes per clip AND one
            # dispatch per bucket)
            clips_i = [
                np.clip(np.round(c * 8192), -32768, 32767).astype(np.int16)
                for c in clips
            ]
            sep_pcm.separate_batch(clips_i)  # compile the int16 batch
            t_sbi = np.inf
            for _ in range(3):
                t0 = time.perf_counter()
                outs_i = sep_pcm.separate_batch(clips_i)
                t_sbi = min(t_sbi, time.perf_counter() - t0)
            assert all(o.dtype == np.int16 for o in outs_i)
            extra["serving_batch8_pcm16_ms_per_clip"] = round(
                t_sbi / 8 * 1e3, 1
            )

        with _row("streaming"):
            # ---- streaming serving surface (serving.StreamingSeparator):
            # warm per-block latency of the fused samples->samples block
            # program (STFT framing + online epochs + OLA, all device-
            # resident) at a realistic config — nfft 512, hop 256, 16-frame
            # blocks (256 ms of audio), M=4. rt_factor = audio seconds per
            # wall second; >> 1 is the realtime margin.
            from overiva_jax.serving import StreamingSeparator

            fs_s = 16000
            blk_cfgs = [
                ("online_iss", "online-iss", {}),
                ("online_tiss", "online-tiss", {"taps": 4, "delay": 2}),
            ]
            rngb = np.random.default_rng(5)
            for name_s, algo_s, kw_s in blk_cfgs:
                seps = StreamingSeparator(
                    algo_s, n_chan=4, nfft=512, hop=256, block_frames=16,
                    n_pass=2, **kw_s,
                )
                blk = rngb.standard_normal(
                    (seps.block_samples, 4)
                ).astype(np.float32)
                seps.process(blk)  # compile
                best_blk = np.inf
                for _ in range(10):
                    t0 = time.perf_counter()
                    out_b = seps.process(blk)
                    best_blk = min(best_blk, time.perf_counter() - t0)
                assert np.isfinite(out_b).all()
                extra[f"{name_s}_block16_ms"] = round(best_blk * 1e3, 2)
                extra[f"{name_s}_rt_factor"] = round(
                    (seps.block_samples / fs_s) / best_blk, 1
                )

        with _row("ogive"):
            # ---- OGIVE at the reference operating point (SURVEY.md
            # §2.3.4: up to 4000 cheap epochs, tol 1e-3 early exit inside
            # ONE lax.while_loop program) — the one behaviorally-distinct
            # reference algorithm. Wall includes the device->host fetch of the converged epoch
            # count (the natural serving read-back). ----
            from overiva_jax.models import ogive as _og

            w0g, a0g, Cxg, Cxg_inv = jax.jit(
                lambda x: _og.ogive_init(x, False)
            )(X)
            use_mix0 = jnp.zeros((F,), bool)
            mu_g = jnp.asarray(0.1, jnp.float32)
            tol_g = jnp.asarray(1e-3, jnp.float32)
            ep0 = jnp.asarray(0, jnp.int32)

            def run_ogive():
                w, a, um, ep, done = _og.ogive_iterations(
                    X, w0g, a0g, use_mix0, Cxg, Cxg_inv, ep0, mu_g, tol_g,
                    4000, "laplace", "demix", 10,
                )
                return w, ep

            jax.block_until_ready(run_ogive())  # warmup
            best_g, iters_g = np.inf, 0
            for _ in range(3):
                t0 = time.perf_counter()
                w_g, ep_g = run_ogive()
                iters_g = int(np.asarray(ep_g))
                best_g = min(best_g, time.perf_counter() - t0)
            check_finite(w_g)
            extra["ogive_wall_to_converge_ms"] = round(best_g * 1e3, 1)
            extra["ogive_iters_done"] = iters_g
            extra["ogive_it_s"] = round(max(iters_g, 1) / best_g, 1)

        with _row("wpe_T512"):
            # ---- WPE dereverb front (extension, ops/wpe.py): full preprocessing
            # pass at the realistic horizon — T=512, M=8, 5 taps, 2 iterations ----
            from overiva_jax.ops.wpe import wpe as _wpe_op

            wpe_jit = jax.jit(
                lambda x: _wpe_op(x, taps=5, delay=2, n_iter=2, diag_load=1e-5)
            )
            t_wpe, Yw = timed(lambda: wpe_jit(X5))
            check_finite(Yw)
            extra["wpe_T512_taps5_ms"] = round(t_wpe * 1e3, 1)

        with _row("tiss_T512"):
            # ---- T-ISS joint dereverb + separation (extension, models/tiss.py):
            # M=8 -> N=3, 5 taps at the realistic horizon T=512 ----
            from overiva_jax.models.tiss import augment_taps, tiss_iterations

            aug_jit = jax.jit(lambda x: augment_taps(x, 5, 2))
            Xt5 = aug_jit(X5)
            Pt0 = jax.jit(
                lambda xt: jnp.zeros((F, M, xt.shape[2]), xt.dtype)
                .at[:, :, :M].set(jnp.eye(M, dtype=xt.dtype))
            )(Xt5)
            t_tiss, (Pt, _) = timed(
                lambda: tiss_iterations(Xt5, Pt0, N_ITER, "laplace", M, n_src=N)
            )
            check_finite(Pt)
            extra["tiss_T512_taps5_it_s"] = round(N_ITER / t_tiss, 1)

        with _row("tip_T512"):
            # ---- T-IP joint (exact MJ-dim IP rows, models/tip.py): the
            # registry default program — 10 warm T-ISS + 10 T-IP epochs ----
            from overiva_jax.models.tip import tip_iterations

            def tip_prog(xt, p0):
                # xt/p0 enter as jit arguments: a closed-over device array
                # would be embedded in the program as a constant
                P1, _ = tiss_iterations(xt, p0, 10, "laplace", M, n_src=N)
                return tip_iterations(xt, P1, 10, "laplace", M, n_src=N)

            tip_jit = jax.jit(tip_prog)
            t_tip, Pt2 = timed(lambda: tip_jit(Xt5, Pt0))
            check_finite(Pt2)
            extra["tip_T512_taps5_ms"] = round(t_tip * 1e3, 1)

            # the bf16 wcov serving tier
            def tip_prog_bf16(xt, p0):
                P1, _ = tiss_iterations(xt, p0, 10, "laplace", M, n_src=N)
                return tip_iterations(
                    xt, P1, 10, "laplace", M, n_src=N, wcov="bf16"
                )

            t_tipb, Pt2b = timed(lambda: jax.jit(tip_prog_bf16)(Xt5, Pt0))
            check_finite(Pt2b)
            extra["tip_T512_taps5_bf16_ms"] = round(t_tipb * 1e3, 1)

        with _row("overiva_ip2"):
            # ---- OverIVA-IP2 (pairwise updates: ~0.55 ms/iter but 3-5x fewer
            # iterations to converge than IP1 — tests/test_ip2.py) ----
            from overiva_jax.models.overiva_ip2 import overiva_ip2_iterations

            t_ip2, W = timed(
                lambda: overiva_ip2_iterations(X, W_hat, Cx, N, N_ITER, "laplace")
            )
            check_finite(W)
            extra["overiva_ip2_it_s"] = round(N_ITER / t_ip2, 1)

        with _row("auxiva_iss"):
            # ---- AuxIVA-ISS speed tier (determined M=N=8, T=128) ----
            Weye = jax.jit(
                lambda x: jnp.broadcast_to(jnp.eye(M, dtype=x.dtype), (F, M, M))
            )(X)
            t_iss, (Wi, _) = timed(
                lambda: auxiva_iss_iterations(X, Weye, N_ITER, "laplace")
            )
            check_finite(Wi)
            extra["auxiva_iss_it_s"] = round(N_ITER / t_iss, 1)

        with _row("overiva_iss"):
            # ---- OverIVA-ISS (M=8 -> N=3, solve-free overdetermined) ----
            t_oiss, (Wo, _) = timed(
                lambda: auxiva_iss_iterations(X, Weye, N_ITER, "laplace", n_src=N)
            )
            check_finite(Wo)
            extra["overiva_iss_it_s"] = round(N_ITER / t_oiss, 1)

        with _row("pca_iss"):
            # ---- PCA (M=8 -> N=3) + ISS, the fast overdetermined path ----
            from overiva_jax.models import auxiva_pca as _pca_mod

            pca_jit = jax.jit(lambda x: _pca_mod.pca(x, N, False), static_argnums=())
            Xr = pca_jit(X)
            WeyeN = jax.jit(
                lambda x: jnp.broadcast_to(jnp.eye(N, dtype=x.dtype), (F, N, N))
            )(Xr)
            t_pca, (Wr, _) = timed(
                lambda: auxiva_iss_iterations(pca_jit(X), WeyeN, N_ITER, "laplace")
            )
            check_finite(Wr)
            extra["pca_iss_it_s"] = round(N_ITER / t_pca, 1)

        with _row("fastmnmf2"):
            # ---- FastMNMF2 (full-rank spatial model, M=8 slots, L=2) ----
            from overiva_jax.models.fastmnmf2 import (
                fastmnmf2_iterations, unit_power, whiten_q,
            )

            Xu, _ = jax.jit(unit_power)(X)
            Qw = jax.jit(whiten_q)(Xu)
            rngf = np.random.default_rng(1)
            g0 = np.full((M, M), 1e-2, np.float32)
            g0[np.arange(M), np.arange(M)] = 1.0
            g0 /= g0.sum(axis=1, keepdims=True)
            Wn = (rngf.random((M, F, 2)) + 0.1).astype(np.float32)
            Hn = (rngf.random((M, 2, 128)) + 0.1).astype(np.float32)
            gd, Wd, Hd = jnp.asarray(g0), jnp.asarray(Wn), jnp.asarray(Hn)
            t_fm, (Qf, _, _, _) = timed(
                lambda: fastmnmf2_iterations(Xu, Qw, gd, Wd, Hd, N_ITER)
            )
            check_finite(Qf)
            extra["fastmnmf2_it_s"] = round(N_ITER / t_fm, 1)

        with _row("ilrma"):
            # ---- ILRMA baseline (determined M=N=8, K=2 NMF components;
            # the reference's quality baseline family) ----
            from overiva_jax.models.ilrma import ilrma_iterations

            rngl = np.random.default_rng(2)
            B0 = jnp.asarray((rngl.random((M, F, 2)) + 0.1).astype(np.float32))
            H0 = jnp.asarray(
                (rngl.random((M, 2, X.shape[0])) + 0.1).astype(np.float32)
            )
            t_il, (Wl, _, _) = timed(
                lambda: ilrma_iterations(X, Weye, B0, H0, N_ITER)
            )
            check_finite(Wl)
            extra["ilrma_it_s"] = round(N_ITER / t_il, 1)

        with _row("five"):
            # ---- FIVE (single-source extraction: whiten + min-eigvector
            # epochs; converges in a handful — time the 10-iteration
            # default program incl. the whitening eigh) ----
            from overiva_jax.models.five import five_iterations, five_whiten

            def five_prog(x):
                xw, _ = five_whiten(x)
                w0 = jnp.zeros((F, M), x.dtype).at[:, 0].set(1.0)
                return five_iterations(xw, w0, 10, "laplace")

            five_jit = jax.jit(five_prog)
            t_fv, wf = timed(lambda: five_jit(X))
            check_finite(wf)
            extra["five_run10_ms"] = round(t_fv * 1e3, 1)


    try:
        _extra_rows()
    except _Budget as b:
        extra["bench_truncated_at"] = str(b)
    if _errors:
        extra["bench_errors"] = _errors

    dev = jax.devices()[0]
    print(
        json.dumps(
            {
                "metric": "overiva_iters_per_sec_M8_N3_F2049",
                "value": round(value, 2),
                "unit": "iter/s",
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
                "extra": extra,
            }
        )
    )


if __name__ == "__main__":
    main()
