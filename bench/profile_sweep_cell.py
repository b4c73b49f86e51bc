"""Decompose the per-chunk cost of one sweep cell on an idle host.

Measures, for a (n_mics, n_src) cell of the WASPAA sweep at batch B:
  sim        host room simulation per instance (producer-thread work)
  stft       host STFT analysis of the batch
  ev_init    _InstanceEval construction (bss_eval reference factorization)
  upload     _to_device of the batched STFT
  algo[i]    steady-state run_batch wall per algorithm (2nd call, compiled),
             split into exec-dispatch vs host fetch when possible
  score      host scoring (synthesis + bss_eval) per algorithm

Usage: python bench/profile_sweep_cell.py [n_mics] [n_src] [batch]
"""

import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mbss_sim import (  # noqa: E402
    DEFAULT_CONFIG,
    _InstanceEval,
    _batch_params,
    applicable,
    simulate_instance,
    stft_pad,
)

from overiva_jax import api  # noqa: E402
from overiva_jax.registry import get_algorithm  # noqa: E402


def main():
    n_mics = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    n_src = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    B = int(sys.argv[3]) if len(sys.argv) > 3 else 10

    cfg = dict(DEFAULT_CONFIG)
    cfg_path = Path(__file__).parent / "waspaa_full_config.json"
    cfg.update(json.loads(cfg_path.read_text()))
    nfft = cfg["nfft"]
    hop = nfft // 2

    seeds = np.random.SeedSequence(cfg["seed"]).generate_state(B).tolist()
    rt60, snr = cfg["rt60"][0], cfg["snr"][0]

    t0 = time.perf_counter()
    simulated = [
        simulate_instance(cfg, s, n_mics, n_src, rt60, snr) for s in seeds
    ]
    t_sim = (time.perf_counter() - t0) / B

    t0 = time.perf_counter()
    X = np.stack(
        [api.stft_analysis(stft_pad(m, nfft, hop), nfft) for m, _ in simulated]
    )
    t_stft = time.perf_counter() - t0

    t0 = time.perf_counter()
    evs = [_InstanceEval(mix, premix, n_src) for mix, premix in simulated]
    t_ev = time.perf_counter() - t0

    print(f"cell m{n_mics}_n{n_src} B={B}  X {X.shape} "
          f"{X.nbytes / 1e6:.0f} MB complex64-equivalent")
    print(f"  sim      {t_sim:7.2f} s/inst   ({t_sim * B:.1f} s/chunk)")
    print(f"  stft     {t_stft:7.2f} s/chunk")
    print(f"  ev_init  {t_ev:7.2f} s/chunk")

    rows = []
    t_score_total = 0.0
    for name, params in cfg["algos"].items():
        if not applicable(name, n_src, n_mics):
            continue
        spec = get_algorithm(name)
        kw = _batch_params(spec, dict(params), B)
        # first call: compile
        t0 = time.perf_counter()
        Yb = spec.run_batch(X, n_src=n_src, **kw)
        t_first = time.perf_counter() - t0
        # second call: steady state
        t0 = time.perf_counter()
        Yb = spec.run_batch(X, n_src=n_src, **kw)
        t_steady = time.perf_counter() - t0
        # scoring (host)
        t0 = time.perf_counter()
        for b in range(B):
            evs[b].score(Yb[b], 0.0, nfft)
        t_score = time.perf_counter() - t0
        t_score_total += t_score
        rows.append((name, t_first, t_steady, t_score))
        print(f"  {name:>16}  first {t_first:7.2f}s  steady {t_steady:6.2f}s"
              f"  score {t_score:6.2f}s/chunk")

    steady_total = sum(r[2] for r in rows)
    print(f"  -- steady algo total {steady_total:.1f} s/chunk"
          f" ({steady_total / B:.2f} s/inst)")
    print(f"  -- score total       {t_score_total:.1f} s/chunk"
          f" ({t_score_total / B:.2f} s/inst)")
    print(f"  -- sim total         {t_sim * B:.1f} s/chunk")


if __name__ == "__main__":
    main()
