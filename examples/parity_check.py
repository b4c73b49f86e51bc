"""User-runnable parity check: this machine's accelerator vs the NumPy oracle.

Runs the full pipeline (simulate -> STFT -> separate -> iSTFT -> bss_eval)
twice per algorithm — once through the JAX path (complex64), once through
the float64 NumPy oracle — and reports the SDR/SIR deltas against the
framework's 0.1 dB acceptance gate (BASELINE.md).

    python examples/parity_check.py [--quick] [--seeds N]

``--seeds N`` runs every case over N seeds (seed 7 — the historical worst
case — plus N-1 more) and reports the per-case worst delta; this is the
round-4 hardware certification probe.

The gauss-model family is certified through the double-float tier
(``acc="f32x2"``, models/overiva_df.py): plain complex64 has an INTRINSIC
~0.11 dB floor on bad seeds (decomposed in PARITY.md — whole-epoch
rounding chaos, not an implementation gap), while the df tier reproduces
the f64 oracle to ~1e-6. The plain-c64 gauss rows are still printed for
the record but marked "(c64 floor)" and excluded from the gate — their
authoritative check is the same-precision 0.02 dB CI gate
(tests/test_integration.py).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from overiva_jax.utils.cache import enable_persistent_cache

enable_persistent_cache()

import overiva_jax.oracle as oracle
from overiva_jax import api
from overiva_jax.oracle.ilrma import ilrma as oracle_ilrma
from overiva_jax.oracle.ilrma_t import ilrma_t as oracle_ilrma_t
from overiva_jax.oracle.wpe import wpe as oracle_wpe


def _online_iss_oracle(X, block=25):
    from overiva_jax.oracle.online_iss import online_iss_run

    return online_iss_run(X[:, :, :2], block, forget=0.985, n_pass=2)


def _online_iss_jax(X, block=25):
    Xc = X[:, :, :2]
    sep = api.OnlineAuxIVAISS(n_freq=Xc.shape[1], n_chan=2, forget=0.985,
                              n_pass=2)
    outs = [sep.process(Xc[s : s + block]) for s in range(0, Xc.shape[0], block)]
    return np.concatenate(outs, axis=0)
from overiva_jax.metrics import bss_eval_sources
from overiva_jax.sim import ShoeBox, circular_mic_array, semi_circle_layout, speech_like


def run_pipeline(separate, mix, premix, nfft):
    hop = nfft // 2
    X = oracle.analysis(oracle.stft_pad(mix, nfft, hop), nfft, hop)
    Y = separate(X)
    y = oracle.synthesis(Y, nfft, hop)[nfft - hop :][: mix.shape[0]]
    refs = premix[:, 0, : mix.shape[0]]
    if Y.shape[2] == refs.shape[0]:
        sdr, sir, _, _ = bss_eval_sources(refs, y.T)
        return sdr, sir
    best = max(range(refs.shape[0]), key=lambda j: abs(np.dot(refs[j], y[:, 0])))
    pair = np.stack([refs[best], refs.sum(0) - refs[best]])
    est = np.stack([y[:, 0], mix[:, 0] - y[:, 0]])
    sdr, sir, _, _ = bss_eval_sources(pair, est, compute_permutation=False)
    return sdr[:1], sir[:1]


def build_mixture(seed):
    fs, n = 16000, 64000
    room = ShoeBox([7.0, 6.0, 3.0], fs=fs, rt60=0.22, seed=seed)
    for k, pos in enumerate(semi_circle_layout([3.5, 3.0, 1.5], np.pi / 2, 2.2, 2, rot=np.pi / 2)):
        room.add_source(pos, speech_like(n, fs, seed=seed * 13 + k))
    room.add_mic_array(circular_mic_array([3.5, 3.0, 1.5], 0.05, 5))
    premix, noise = room.simulate(return_premix=True, snr=25.0)
    mix = (premix.sum(axis=0) + noise).T[:n]
    return mix, premix


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--quick", action="store_true", help="2 algorithms only")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--seeds", type=int, default=1,
                   help="number of seeds (seed 7 first, then 0,1,2,...)")
    p.add_argument("--cases", type=str, default="",
                   help="comma-separated substring filter on case names")
    args = p.parse_args(argv)

    if args.seeds > 1:
        first = args.seed  # 7 (the historical worst case) unless overridden
        seeds = [first] + [s for s in range(args.seeds * 2) if s != first]
        seeds = seeds[: args.seeds]
    else:
        seeds = [args.seed]

    # (name, oracle_fn, jax_fn, gated) — ungated rows are informational
    # (the plain-c64 gauss floor, PARITY.md)
    cases = [
        ("overiva M=5,N=2", lambda X: oracle.overiva(X, n_src=2, n_iter=15),
         lambda X: api.overiva(X, n_src=2, n_iter=15)),
        ("auxiva M=N=2", lambda X: oracle.auxiva(X[:, :, :2], n_iter=15),
         lambda X: api.auxiva(X[:, :, :2], n_iter=15)),
    ]
    if not args.quick:
        cases += [
            ("overiva-gauss (c64 floor)",
             lambda X: oracle.overiva(X, n_src=2, n_iter=15, model="gauss"),
             lambda X: api.overiva(X, n_src=2, n_iter=15, model="gauss"),
             False),
            ("overiva-gauss df",
             lambda X: oracle.overiva(X, n_src=2, n_iter=15, model="gauss"),
             lambda X: api.overiva(X, n_src=2, n_iter=15, model="gauss",
                                   acc="f32x2")),
            ("auxiva-gauss df",
             lambda X: oracle.auxiva(X[:, :, :2], n_iter=15, model="gauss"),
             lambda X: api.auxiva(X[:, :, :2], n_iter=15, model="gauss",
                                  acc="f32x2")),
            ("auxiva_pca", lambda X: oracle.auxiva_pca(X, n_src=2, n_iter=15),
             lambda X: api.auxiva_pca(X, n_src=2, n_iter=15)),
            ("auxiva_iss M=N=2", lambda X: oracle.auxiva_iss(X[:, :, :2], n_iter=15),
             lambda X: api.auxiva_iss(X[:, :, :2], n_iter=15)),
            ("ogive N=1", lambda X: oracle.ogive(X, n_iter=60, step_size=0.05, tol=0),
             lambda X: api.ogive(X, n_iter=60, step_size=0.05, tol=0)),
            ("fastmnmf2 N=2", lambda X: oracle.fastmnmf2(X, n_src=2, n_iter=12, seed=5),
             lambda X: api.fastmnmf2(X, n_src=2, n_iter=12, seed=5)),
            ("fastmnmf N=2", lambda X: oracle.fastmnmf(X, n_src=2, n_iter=12, seed=5),
             lambda X: api.fastmnmf(X, n_src=2, n_iter=12, seed=5)),
            ("sparseauxiva M=N=2",
             lambda X: oracle.sparseauxiva(X[:, :, :2], n_iter=15),
             lambda X: api.sparseauxiva(X[:, :, :2], n_iter=15)),
            ("tiss M=5,N=2",
             lambda X: oracle.tiss(X, n_src=2, taps=3, delay=2, n_iter=15),
             lambda X: api.tiss(X, n_src=2, taps=3, delay=2, n_iter=15)),
            ("tip M=5,N=2",
             lambda X: oracle.tip(X, n_src=2, taps=3, delay=2, n_iter=5,
                                  warm_iter=5),
             lambda X: api.tip(X, n_src=2, taps=3, delay=2, n_iter=5,
                               warm_iter=5)),
            # the df certification tier extended to the joint family
            # (models/joint_df.py): tip was the
            # thinnest-margin gated family in round 4 (0.061/0.027 dB)
            ("tiss df M=5,N=2",
             lambda X: oracle.tiss(X, n_src=2, taps=3, delay=2, n_iter=15),
             lambda X: api.tiss(X, n_src=2, taps=3, delay=2, n_iter=15,
                                acc="f32x2")),
            ("tip df M=5,N=2",
             lambda X: oracle.tip(X, n_src=2, taps=3, delay=2, n_iter=5,
                                  warm_iter=5),
             lambda X: api.tip(X, n_src=2, taps=3, delay=2, n_iter=5,
                               warm_iter=5, acc="f32x2")),
            ("ilrma_t M=N=2",
             lambda X: oracle_ilrma_t(
                 X[:, :, :2], taps=3, delay=2, n_iter=15, seed=5
             ),
             lambda X: api.ilrma_t(X[:, :, :2], taps=3, delay=2, n_iter=15,
                                   seed=5)),
            # ---- round-5 additions: the families that were missing
            # from the hardware instrument (they were CI-gated
            # only) — now every registry family has a hardware case ----
            # five and overiva-ip2 carry an INTRINSIC c64 floor like the
            # gauss family (measured 2026-08-19 on seed 7: c64 vs oracle
            # 0.16 / 2.86 dB, while c128 vs oracle is 0.0000/0.0000 dB for
            # both — pure trajectory chaos, zero implementation error; the
            # IP2 GEVD's 2x2 eigenvector branch and FIVE's whitened power
            # ordering are discontinuous in rounding). Authoritative gates:
            # the same-precision CI checks (tests/test_ip2.py /
            # test_five.py exact-parity + tests/test_integration.py 0.02
            # dB). PARITY.md "round 5" has the decomposition.
            ("five N=1 (c64 floor)", lambda X: oracle.five(X, n_iter=10),
             lambda X: api.five(X, n_iter=10), False),
            ("ilrma M=N=2",
             lambda X: oracle_ilrma(X[:, :, :2], n_iter=15, seed=5),
             lambda X: api.ilrma(X[:, :, :2], n_iter=15, seed=5)),
            ("overiva-iss M=5,N=2",
             lambda X: oracle.overiva_iss(X, n_src=2, n_iter=15),
             lambda X: api.overiva_iss(X, n_src=2, n_iter=15)),
            ("overiva-ip2 (c64 floor)",
             lambda X: oracle.overiva_ip2(X, n_src=2, n_iter=8),
             lambda X: api.overiva_ip2(X, n_src=2, n_iter=8), False),
            # wpe certified end-to-end through the cascade it fronts
            ("wpe+overiva M=5,N=2",
             lambda X: oracle.overiva(
                 oracle_wpe(X, taps=3, delay=2, n_iter=2), n_src=2, n_iter=15
             ),
             lambda X: api.overiva(
                 api.wpe(X, taps=3, delay=2, n_iter=2), n_src=2, n_iter=15
             )),
            ("online-iss M=N=2 (stream)", _online_iss_oracle,
             _online_iss_jax),
        ]

    if args.cases:
        keys = [k.strip() for k in args.cases.split(",") if k.strip()]
        cases = [c for c in cases if any(k in c[0] for k in keys)]

    mixtures = {s: build_mixture(s) for s in seeds}

    hdr = f"{'algorithm':26s} {'|dSDR| dB':>10s} {'|dSIR| dB':>10s}"
    print(f"seeds: {seeds}")
    print(f"{hdr}  gate 0.1 dB (worst over seeds)")
    worst = 0.0
    for case in cases:
        name, f_oracle, f_jax = case[0], case[1], case[2]
        gated = case[3] if len(case) > 3 else True
        dsdr = dsir = 0.0
        for s in seeds:
            mix, premix = mixtures[s]
            sdr_o, sir_o = run_pipeline(f_oracle, mix, premix, 1024)
            sdr_j, sir_j = run_pipeline(f_jax, mix, premix, 1024)
            dsdr = max(dsdr, float(np.max(np.abs(sdr_j - sdr_o))))
            dsir = max(dsir, float(np.max(np.abs(sir_j - sir_o))))
        if gated:
            worst = max(worst, dsdr, dsir)
            flag = "OK" if max(dsdr, dsir) < 0.1 else "FAIL"
        else:
            flag = "(info only)"
        print(f"{name:26s} {dsdr:10.4f} {dsir:10.4f}  {flag}", flush=True)
    print(f"\nworst gated delta: {worst:.4f} dB -> "
          f"{'PASS' if worst < 0.1 else 'FAIL'}")
    return 0 if worst < 0.1 else 1


if __name__ == "__main__":
    raise SystemExit(main())
