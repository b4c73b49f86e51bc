"""Reproduce the r3 sweep NaN chunks: overiva-gauss @ m8_n3, ip2 @ m2_n2.

Finds which batch element goes non-finite, then re-runs that element
through the single-instance path and (optionally) the f64 oracle.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mbss_sim import DEFAULT_CONFIG, simulate_instance, stft_pad  # noqa: E402

from overiva_jax import api  # noqa: E402

CASES = [
    # (n_mics, n_src, algo-params, batch_fn, single_fn)
    (8, 3, {"n_iter": 30, "init_eig": True, "model": "gauss"},
     "overiva_batch", "overiva"),
    (2, 2, {"n_iter": 10}, "overiva_ip2_batch", "overiva_ip2"),
]


def main():
    cfg = dict(DEFAULT_CONFIG)
    cfg.update(json.loads(
        (Path(__file__).parent / "waspaa_full_config.json").read_text()
    ))
    nfft = cfg["nfft"]
    hop = nfft // 2
    all_seeds = np.random.SeedSequence(cfg["seed"]).generate_state(20).tolist()
    rt60, snr = cfg["rt60"][0], cfg["snr"][0]

    for n_mics, n_src, params, bname, sname in CASES:
        for half in (0, 1):
            seeds = all_seeds[half * 10 : (half + 1) * 10]
            sims = [
                simulate_instance(cfg, s, n_mics, n_src, rt60, snr)
                for s in seeds
            ]
            X = np.stack([
                api.stft_analysis(stft_pad(m, nfft, hop), nfft)
                for m, _ in sims
            ])
            t0 = time.perf_counter()
            Yb = getattr(api, bname)(X, n_src=n_src, **params)
            dt = time.perf_counter() - t0
            bad = [
                b for b in range(len(seeds))
                if not np.all(np.isfinite(Yb[b]))
            ]
            print(f"{bname} m{n_mics}_n{n_src} half{half}: {dt:.1f}s "
                  f"non-finite elements {bad} "
                  f"(seeds {[seeds[b] for b in bad]})")
            for b in bad:
                Y1 = getattr(api, sname)(X[b], n_src=n_src, **params)
                print(f"  single-path seed {seeds[b]}: "
                      f"finite={np.all(np.isfinite(Y1))}")
            if bad:
                return  # stop after first bad chunk; keep runtime bounded


if __name__ == "__main__":
    main()
