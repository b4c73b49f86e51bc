"""Monte-Carlo room-simulation sweep — mirror of the reference's
``mbss_sim.py`` (SURVEY.md §3.4): JSON config, cross-product of
(seed, n_mics, n_src, rt60, snr, algo), per-instance result JSON with
resume-by-skip, aggregation to a summary table.

    python bench/mbss_sim.py bench/mbss_sim_config.json --out data/sweep1
    python bench/mbss_sim.py --aggregate data/sweep1

Design differences from the reference, on purpose:
- The reference fans out with a multiprocessing pool (one CPU per instance);
  here the accelerator separates mixtures inside fused XLA programs
  (it is the accelerator; host processes would fight over it), while room
  simulation and bss_eval remain host-side.
- Results are one JSON file per instance (append-only dir) instead of one
  growing dump, so a killed sweep resumes by skipping existing keys
  (SURVEY.md §5.3).
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import os

import jax

from overiva_jax import api
from overiva_jax.metrics import BssEvalReferences
from overiva_jax.oracle import stft_pad
from overiva_jax.registry import applicable, get_algorithm
from overiva_jax.sim import (
    ShoeBox,
    circular_mic_array,
    load_wav_sources,
    semi_circle_layout,
    speech_like,
)

DEFAULT_CONFIG = {
    "repeats": 3,
    "seed": 12345,
    "fs": 16000,
    "duration": 5.0,
    "nfft": 4096,
    "room_dim": [8.0, 9.0, 3.0],
    "rt60": [0.25],
    "snr": [25.0],
    "n_mics": [2, 3, 5, 8],
    "n_srcs": [1, 2, 3],
    "algos": {
        "auxiva": {"n_iter": 20},
        "auxiva-gauss": {"n_iter": 20},
        "auxiva-iss": {"n_iter": 20},
        "overiva": {"n_iter": 20},
        "overiva-gauss": {"n_iter": 20},
        "overiva-iss": {"n_iter": 20},
        "overiva-ip2": {"n_iter": 10},
        "auxiva_pca": {"n_iter": 20},
        "ilrma": {"n_iter": 30, "n_components": 2},
        "ogive": {"n_iter": 2000, "step_size": 0.05, "tol": 1e-3},
    },
}


def _algo_key(name: str) -> str:
    """Registry name for a sweep-config key: ``"tip-gauss@taps3"`` resolves
    the algorithm ``tip-gauss`` while keeping the full key as the result
    column — matched-arm A/B sweeps of one algorithm under different
    kwargs in a single config."""
    return name.split("@", 1)[0]


def run_algo(name: str, X, n_src: int, params: dict):
    if not applicable(_algo_key(name), n_src, X.shape[2]):
        return None
    return get_algorithm(_algo_key(name))(X, n_src=n_src, **params)


def simulate_instance(cfg: dict, seed: int, n_mics: int, n_src: int, rt60: float, snr: float):
    """CPU-side: build + simulate one room. Returns (mix, premix)."""
    fs = cfg["fs"]
    n = int(cfg["duration"] * fs)
    rng = np.random.default_rng(seed)

    room = ShoeBox(cfg["room_dim"], fs=fs, rt60=rt60, seed=seed)
    center = np.asarray(cfg["room_dim"]) / 2
    # sources on an arc AROUND the mic array: equidistant, random orientation
    src_pos = semi_circle_layout(
        [center[0], center[1], 1.5], np.pi / 2, 2.5, n_src,
        rot=rng.uniform(-np.pi, np.pi),
    )
    # clamp inside the room
    src_pos = np.clip(src_pos, 0.3, np.asarray(cfg["room_dim"]) - 0.3)
    # real speech when the config points at a wav directory (reference:
    # CMU ARCTIC via pyroomacoustics.datasets); synthetic otherwise
    if cfg.get("source_dir"):
        signals = load_wav_sources(cfg["source_dir"], n_src, n, fs, seed=seed)
    else:
        signals = np.stack(
            [speech_like(n, fs, seed=seed * 1009 + k) for k in range(n_src)]
        )
    for k in range(n_src):
        room.add_source(src_pos[k], signals[k])
    room.add_mic_array(
        circular_mic_array([center[0], center[1], 1.5], 0.05, n_mics)
    )
    premix, noise = room.simulate(return_premix=True, snr=snr)
    mix = (premix.sum(axis=0) + noise).T
    # fixed length (exactly `duration` seconds): the raw convolution length
    # varies with each room's RIR tail, which would give every instance its
    # own STFT shape — static shapes keep one compiled program per
    # (n_mics, n_src) cell and make same-shape batching possible
    # (DESIGN.md rules; XLA recompiles per shape)
    return mix[:n], premix[:, :, :n]


class _InstanceEval:
    """Per-instance evaluation context: shared reference-side Gram
    factorizations (BssEvalReferences) across every algorithm of the
    instance; single-output algorithms score against estimate-dependent
    (target, rest) pairs, cached per target."""

    def __init__(self, mix, premix, n_src):
        self.mix = mix
        self.n_src = n_src
        self.refs = premix[:, 0, : mix.shape[0]]
        self.ev = BssEvalReferences(self.refs) if n_src > 1 else None
        self.pair_evs = {}
        # score_time runs on the harness's scoring thread pool; the pair
        # cache is the only mutated state (evaluate() is read-only)
        import threading

        self._pair_lock = threading.Lock()
        if n_src > 1:
            self.sdr_mix, self.sir_mix, _, _ = self.ev.evaluate(
                np.tile(mix[:, 0], (n_src, 1))
            )
        else:
            self.sdr_mix = np.array([0.0])
            self.sir_mix = np.array([0.0])

    def score(self, Y, runtime, nfft):
        """Separated STFT (host or device array) -> result dict."""
        hop = nfft // 2
        y = api.stft_synthesis(Y, nfft)[nfft - hop :][: self.mix.shape[0]]
        return self.score_time(y, runtime)

    def score_time(self, y, runtime):
        """Separated time-domain signals (n_samples, n_out) -> result dict."""
        mix, refs, n_src = self.mix, self.refs, self.n_src
        if y.shape[1] == n_src and n_src > 1:
            # reference-ordered rows (mir_eval convention), so the mix
            # scores (also reference-ordered) align without perm indexing
            sdr, sir, sar, perm = self.ev.evaluate(y.T)
            return {
                "runtime": runtime,
                "sdr": sdr.tolist(),
                "sir": sir.tolist(),
                "sdr_improvement": (sdr - self.sdr_mix).tolist(),
                "sir_improvement": (sir - self.sir_mix).tolist(),
            }
        # single output (ogive / five or n_src == 1)
        best = max(
            range(refs.shape[0]),
            key=lambda j: abs(np.dot(refs[j], y[:, 0])),
        )
        est = (
            np.stack([y[:, 0], mix[:, 0] - y[:, 0]])
            if refs.shape[0] > 1
            else y.T[:1]
        )
        with self._pair_lock:
            if best not in self.pair_evs:
                pair = (
                    np.stack([refs[best], refs.sum(0) - refs[best]])
                    if refs.shape[0] > 1
                    else refs[:1]
                )
                self.pair_evs[best] = BssEvalReferences(pair)
        sdr, sir, _, _ = self.pair_evs[best].evaluate(
            est, compute_permutation=False
        )
        return {
            "runtime": runtime,
            "sdr": [float(sdr[0])],
            # N=1 instances have no interference: SIR is +inf and
            # meaningless — such rows are scored by SDR only
            "sir": [float(sir[0])] if np.isfinite(sir[0]) else [],
        }


def one_instance(cfg, seed, n_mics, n_src, rt60, snr, simulated=None):
    """Run every applicable algorithm on one (possibly pre-simulated) room."""
    nfft = cfg["nfft"]
    hop = nfft // 2
    mix, premix = simulated or simulate_instance(cfg, seed, n_mics, n_src, rt60, snr)

    X = api.stft_analysis(stft_pad(mix, nfft, hop), nfft)
    if cfg.get("wpe"):  # optional dereverb front (extension; see api.wpe)
        X = api.wpe(X, **cfg["wpe"])
    ev = _InstanceEval(mix, premix, n_src)

    results = {}
    for name, params in cfg["algos"].items():
        try:
            t0 = time.perf_counter()
            Y = run_algo(name, X, n_src, params)
            if Y is None:
                continue
            runtime = time.perf_counter() - t0
            results[name] = ev.score(Y, runtime, nfft)
        except Exception as e:  # a failed algo shouldn't kill the instance
            results[name] = {"error": f"{type(e).__name__}: {e}"}
    return results


def _batch_params(spec, params, B):
    """Adapt per-instance params for a batched call: seed-consuming
    families take an explicit per-element ``seeds`` list so every element
    reproduces its single-instance run exactly."""
    import inspect

    params = dict(params)
    if "seeds" in inspect.signature(spec.batch).parameters:
        if "seeds" not in params:
            params["seeds"] = [params.pop("seed", 0)] * B
    return params


def batch_instances(cfg, group, simulated):
    """Run every applicable algorithm on a same-shape instance group in ONE
    fused batched XLA program per algorithm (SURVEY.md §3.4's fan-out,
    accelerator-side: the reference fans out with a process pool; here the
    batch axis is a vmap inside the program). Per-element results are
    identical to one_instance's (registry batch contract,
    tests/test_batch_api.py); reported runtime is the batch wall divided
    by the group size.

    group: list of (seed, n_mics, n_src, rt60, snr) sharing (n_mics,
    n_src); simulated: matching list of (mix, premix). Returns one results
    dict per instance."""
    nfft = cfg["nfft"]
    hop = nfft // 2
    B = len(group)
    n_src, n_mics = group[0][2], group[0][1]
    # Device-resident input path: ONE upload of the real mixture batch
    # (half the bytes of the complex STFT), device FFT, and the batch STFT
    # never comes back to host.
    xb = np.stack([stft_pad(m, nfft, hop) for m, _ in simulated])
    Xd = api.stft_analysis_batch(xb, nfft, device=True)
    if cfg.get("wpe"):  # optional dereverb front (extension; see api.wpe)
        Xd = api.wpe_batch(Xd, device=True, **cfg["wpe"])
    evs = [
        _InstanceEval(mix, premix, n_src) for mix, premix in simulated
    ]
    n_samp = simulated[0][0].shape[0]

    results = [dict() for _ in range(B)]
    # Host bss_eval scoring runs on a thread pool so it overlaps the NEXT
    # algorithm's device execution (the device is idle during scoring
    # otherwise; NumPy FFT/BLAS release the GIL). Device work — run_batch
    # and the fused batch synthesis — stays on this thread.
    from concurrent.futures import ThreadPoolExecutor, wait as _fwait

    # Overlapped scoring inflates the reported runtime on CPU-starved
    # hosts (host bss_eval threads contend with dispatch during the next
    # algorithm's timed window). cfg["strict_timing"] drains
    # pending scores before every timed run when runtime fidelity matters
    # more than sweep wall time.
    strict = bool(cfg.get("strict_timing"))
    futures = {}
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        for name, params in cfg["algos"].items():
            if not applicable(_algo_key(name), n_src, n_mics):
                continue
            spec = get_algorithm(_algo_key(name))
            if strict and futures:
                _fwait(list(futures.values()))
            try:
                t0 = time.perf_counter()
                Yb = spec.run_batch(
                    Xd, n_src=n_src, device=True,
                    **_batch_params(spec, params, B),
                )
                jax.block_until_ready(Yb)  # execution, not dispatch
                runtime = (time.perf_counter() - t0) / B
            except Exception as e:  # a failed dispatch marks the whole group
                for b in range(B):
                    results[b][name] = {"error": f"{type(e).__name__}: {e}"}
                continue
            # ONE fused iSTFT + ONE host transfer for the whole batch
            # (per-lane synthesis paid a dispatch + transfer each); on a
            # batch-synthesis failure, fall back to per-lane synthesis so
            # one bad lane cannot void the other B-1
            lanes = [None] * B
            lane_err = {}
            try:
                yb = api.stft_synthesis_batch(Yb, nfft)
                lanes = list(yb[:, nfft - hop:][:, :n_samp])
            except Exception:
                for b in range(B):
                    try:
                        y1 = api.stft_synthesis(Yb[b], nfft)
                        lanes[b] = np.asarray(y1)[nfft - hop:][:n_samp]
                    except Exception as e1:
                        lane_err[b] = f"{type(e1).__name__}: {e1}"
            for b in range(B):  # score per element: one bad lane must not
                if b in lane_err:  # void the other B-1
                    results[b][name] = {"error": lane_err[b]}
                    continue
                if not np.all(np.isfinite(lanes[b])):
                    results[b][name] = {
                        "error": "FloatingPointError: "
                        "non-finite separation output"
                    }
                    continue
                futures[(b, name)] = pool.submit(
                    evs[b].score_time, lanes[b], runtime
                )
        for (b, name), fut in futures.items():
            try:
                res = fut.result()
                res["batched"] = B
                results[b][name] = res
            except Exception as e:
                results[b][name] = {"error": f"{type(e).__name__}: {e}"}
    return results


def instance_key(seed, n_mics, n_src, rt60, snr):
    return f"s{seed}_m{n_mics}_n{n_src}_rt{rt60}_snr{snr}"


def sweep(cfg: dict, out_dir: Path, prefetch: int = 2, batch: int | None = None):
    """Run the sweep. Room simulation (CPU) is prefetched on worker threads
    so it overlaps with device separation — the accelerator analog of the
    reference's multiprocessing pool (SURVEY.md §3.4: there, every worker
    was a full pipeline; here the accelerator is the serial resource and the
    CPU work hides behind it).

    Same-shape instances (same n_mics, n_src; T and F are sweep-constant)
    are grouped into chunks of up to ``batch`` (config key "batch",
    default 8) and separated through the fused ``*_batch`` programs — one
    accelerator dispatch per algorithm per chunk instead of per instance.
    Per-instance JSONs and resume-by-skip are unchanged; ``batch=1``
    reproduces the one-at-a-time path exactly."""
    import queue
    import threading

    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "config.json").write_text(json.dumps(cfg, indent=2))
    base = np.random.SeedSequence(cfg["seed"]).generate_state(cfg["repeats"])
    grid = [
        g
        for g in itertools.product(
            base.tolist(), cfg["n_mics"], cfg["n_srcs"], cfg["rt60"], cfg["snr"]
        )
        if g[2] <= g[1]  # n_src <= n_mics
    ]
    todo = [
        g for g in grid if not (out_dir / f"{instance_key(*g)}.json").exists()
    ]
    skipped = len(grid) - len(todo)
    cap = int(batch if batch is not None else cfg.get("batch", 8))

    # group by algorithm-relevant shape (n_mics, n_src), preserve order
    by_shape: dict[tuple, list] = {}
    for g in todo:
        by_shape.setdefault((g[1], g[2]), []).append(g)
    chunks = [
        grp[i : i + cap]
        for grp in by_shape.values()
        for i in range(0, len(grp), cap)
    ]
    order = [g for chunk in chunks for g in chunk]  # producer order

    q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1) + cap - 1)

    def producer():
        for g in order:
            q.put(simulate_instance(cfg, *g))
        q.put(None)

    threading.Thread(target=producer, daemon=True).start()

    done = 0
    for chunk in chunks:
        simulated = [q.get() for _ in chunk]
        n_real = len(chunk)
        run_chunk, run_sim = chunk, simulated
        # pad partial chunks up to the cap when this cell already needs the
        # cap-sized program anyway: ONE batch shape per (n_mics, n_src)
        # cell per algorithm (a fresh program compile costs tens of
        # seconds; a padded batch lane costs microseconds)
        grp_len = len(by_shape[(chunk[0][1], chunk[0][2])])
        if n_real < cap and grp_len > cap:
            idx = [i % n_real for i in range(cap - n_real)]
            run_chunk = chunk + [chunk[i] for i in idx]
            run_sim = simulated + [simulated[i] for i in idx]
        t0 = time.perf_counter()
        if len(run_chunk) == 1:
            all_results = [one_instance(cfg, *chunk[0], simulated=simulated[0])]
        else:
            all_results = batch_instances(cfg, run_chunk, run_sim)[:n_real]
        wall = (time.perf_counter() - t0) / n_real
        for g, results in zip(chunk, all_results):
            seed, n_mics, n_src, rt60, snr = g
            key = instance_key(*g)
            record = {
                "seed": seed, "n_mics": n_mics, "n_src": n_src,
                "rt60": rt60, "snr": snr,
                "wall": wall, "results": results,
            }
            (out_dir / f"{key}.json").write_text(json.dumps(record))
            done += 1
            print(
                f"[{done}/{len(todo)}] {key}  ({wall:.1f}s/inst, "
                f"batch {len(chunk)})",
                flush=True,
            )
    print(f"sweep complete: {done} new, {skipped} skipped (resumed)")


def _load_rows(out_dir: Path):
    rows = []
    for f in sorted(out_dir.glob("s*.json")):
        rec = json.loads(f.read_text())
        for algo, res in rec["results"].items():
            if "error" in res:
                continue
            sir = np.asarray(res.get("sir", []), dtype=float)
            sir = sir[np.isfinite(sir)]  # N=1 rows carry no SIR (see above)

            def _mean(key):
                v = np.asarray(res.get(key, []), dtype=float)
                v = v[np.isfinite(v)]
                return float(np.mean(v)) if v.size else float("nan")

            rows.append(
                {
                    "key": instance_key(
                        rec["seed"], rec["n_mics"], rec["n_src"],
                        rec["rt60"], rec["snr"],
                    ),
                    "algo": algo, "n_mics": rec["n_mics"], "n_src": rec["n_src"],
                    "rt60": rec["rt60"], "snr": rec["snr"],
                    "sdr": float(np.mean(res["sdr"])),
                    "sir": float(np.mean(sir)) if sir.size else float("nan"),
                    "sdr_improvement": _mean("sdr_improvement"),
                    "sir_improvement": _mean("sir_improvement"),
                    "runtime": res["runtime"],
                }
            )
    return rows


def compare(base_dir: Path, out_dir: Path):
    """Paired per-instance comparison of two sweeps (same config except
    the treatment — e.g. a ``"wpe"`` key): mean SIR/SDR deltas per
    (algo, cell) over instances present in BOTH dirs. The pairing (same
    seed = same room/sources) cancels the between-room variance that
    dominates unpaired comparisons. Writes ``compare.csv`` to out_dir."""
    import pandas as pd

    base = {(r["key"], r["algo"]): r for r in _load_rows(base_dir)}
    rows = []
    for r in _load_rows(out_dir):
        b = base.get((r["key"], r["algo"]))
        if b is None:
            continue
        rows.append(
            {
                "algo": r["algo"], "n_mics": r["n_mics"], "n_src": r["n_src"],
                "d_sir": r["sir"] - b["sir"],
                "d_sdr": r["sdr"] - b["sdr"],
                "sir": r["sir"], "sir_base": b["sir"],
            }
        )
    if not rows:
        print("no paired instances found")
        return
    df = pd.DataFrame(rows)
    summary = (
        df.groupby(["algo", "n_mics", "n_src"])
        [["d_sir", "d_sdr", "sir_base", "sir"]]
        .agg(d_sir=("d_sir", "mean"), d_sir_std=("d_sir", "std"),
             d_sdr=("d_sdr", "mean"), sir_base=("sir_base", "mean"),
             sir=("sir", "mean"), n=("d_sir", "size"))
        .round(2)
    )
    print(f"paired deltas: {out_dir} vs baseline {base_dir}")
    print(summary.to_string())
    summary.to_csv(out_dir / "compare.csv")
    print(f"written to {out_dir/'compare.csv'}")


def aggregate(out_dir: Path, plot: bool = False):
    rows = _load_rows(out_dir)
    if not rows:
        print("no results found")
        return
    import pandas as pd

    df = pd.DataFrame(rows)
    summary = (
        df.groupby(["algo", "n_mics", "n_src"])[["sdr", "sir", "runtime"]]
        .agg(["mean", "std"])
        .round(2)
    )
    print(summary.to_string())
    summary.to_csv(out_dir / "summary.csv")
    if plot:
        import matplotlib

        matplotlib.use("Agg")
        import seaborn as sns

        # the reference's mbss_sim_plot.py figure set (SURVEY.md §2.1):
        # raw SIR, Delta-SDR/Delta-SIR improvement distributions, runtime
        figures = [
            ("sir", "box", "sir_vs_mics.png"),
            ("sdr_improvement", "box", "sdr_improvement_vs_mics.png"),
            ("sir_improvement", "box", "sir_improvement_vs_mics.png"),
            ("runtime", "point", "runtime_vs_mics.png"),
        ]
        for metric, kind, fname in figures:
            sub = df.dropna(subset=[metric])
            if sub.empty:
                continue
            g = sns.catplot(
                data=sub, x="n_mics", y=metric, hue="algo", col="n_src",
                kind=kind, sharey=False,
            )
            if metric == "runtime":
                g.set(yscale="log")
            g.savefig(out_dir / fname, dpi=120)
            print(f"plot written to {out_dir/fname}")


def main(argv=None):
    # persistent cache only for CLI runs: tests import this module, and
    # the suite keeps the persistent cache off (tests/conftest.py)
    from overiva_jax.utils.cache import enable_persistent_cache

    enable_persistent_cache()

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("config", nargs="?", default=None)
    p.add_argument("--out", type=str, default="data/sweep")
    p.add_argument("--aggregate", type=str, default=None, metavar="DIR")
    p.add_argument(
        "--compare", type=str, default=None, metavar="BASEDIR",
        help="with --aggregate DIR: paired per-instance SIR/SDR deltas of "
        "DIR vs this baseline sweep (matched-arm A/B, e.g. a wpe key)",
    )
    p.add_argument("--plot", action="store_true")
    p.add_argument(
        "--batch", type=int, default=None,
        help="max same-shape instances per fused batched program "
        "(default: config key 'batch' or 8; 1 = one-at-a-time)",
    )
    p.add_argument(
        "--strict-timing", action="store_true",
        help="drain pending scoring threads before each timed run: "
        "runtime fidelity over sweep wall time (scoring otherwise "
        "overlaps the next algorithm's window and can inflate its "
        "reported runtime on CPU-starved hosts)",
    )
    args = p.parse_args(argv)

    if args.aggregate:
        if args.compare:
            compare(Path(args.compare), Path(args.aggregate))
        else:
            aggregate(Path(args.aggregate), plot=args.plot)
        return
    cfg = dict(DEFAULT_CONFIG)
    if args.config:
        cfg.update(json.loads(Path(args.config).read_text()))
    if args.strict_timing:
        cfg["strict_timing"] = True
    sweep(cfg, Path(args.out), batch=args.batch)


if __name__ == "__main__":
    main()
