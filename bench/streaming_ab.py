"""A/B: streaming joint T-ISS vs OnlineWPE->OnlineISS cascade vs plain.

Reverberant determined 2x2 scene (the cascade-negative regime from
docs/DESIGN.md §7): RT60 0.35, nfft 512 (32 ms window << 350 ms tail),
10 s, block 16 frames. Scores last-4s SIR via bss_eval vs mic-0 images.

This is the measurement behind docs/DESIGN.md §8 "streaming" (seeds
0/1/2: plain 4.6/7.4/1.3, cascade 1.8/3.0/1.6, OnlineTISS solve-t4
3.2/7.8/2.8 dB) and the OnlineTISS default choices (solve > steer,
taps=4 > 6, shared forget ~= longer tap_forget).

    python bench/streaming_ab.py
"""
import sys

import numpy as np

sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parent.parent))
from overiva_jax.api import (
    OnlineAuxIVAISS,
    OnlineTISS,
    OnlineWPE,
    stft_analysis,
)
from overiva_jax.metrics.bss_eval import bss_eval_sources
from overiva_jax.oracle import hann, stft_pad, synthesis_window
from overiva_jax.sim import ShoeBox, circular_mic_array, semi_circle_layout
from overiva_jax.sim.sources import speech_like

FS, DUR, NFFT, BLK, RT60 = 16000, 10.0, 512, 16, 0.35
HOP = NFFT // 2
FORGET = 0.99


def scene(seed):
    n = int(DUR * FS)
    room = ShoeBox([7.0, 5.0, 3.0], fs=FS, rt60=RT60, seed=seed)
    sp = semi_circle_layout([3.5, 3.5, 1.5], np.pi / 2, 1.8, 2)
    for k in range(2):
        room.add_source(sp[k], speech_like(n, FS, seed=seed * 31 + k))
    room.add_mic_array(circular_mic_array([3.5, 2.2, 1.5], 0.04, 2))
    premix, noise = room.simulate(return_premix=True, snr=25.0)
    mix = (premix.sum(axis=0) + noise).T[:n]
    X = stft_analysis(stft_pad(mix, NFFT, HOP), NFFT)
    return X, premix[:, 0, :n], n


def run_stream(X, n, make_sep, drv=None):
    T, F, M = X.shape
    sep = make_sep(F, M)
    win_s = synthesis_window(hann(NFFT), HOP)
    y = np.zeros(((T - 1) * HOP + NFFT, M))
    for start in range(0, T - BLK + 1, BLK):
        X_blk = X[start : start + BLK]
        if drv is not None:
            X_blk = drv.process(X_blk)
        Y_blk = sep.process(X_blk)
        frames = np.fft.irfft(Y_blk, n=NFFT, axis=1) * win_s[None, :, None]
        for j in range(BLK):
            s = (start + j) * HOP
            y[s : s + NFFT] += frames[j]
    return y[NFFT - HOP :][:n]


def last4_sir(refs, est, n):
    seg = slice(n - 4 * FS, n)
    _, sir, _, _ = bss_eval_sources(refs[:, seg], est[seg].T)
    return sir.mean()


for seed in (0, 1, 2):
    X, refs, n = scene(seed)
    r = {}
    est = run_stream(
        X, n, lambda F, M: OnlineAuxIVAISS(F, M, forget=FORGET, n_pass=2)
    )
    r["plain"] = last4_sir(refs, est, n)
    est = run_stream(
        X, n,
        lambda F, M: OnlineAuxIVAISS(F, M, forget=FORGET, n_pass=2),
        drv=OnlineWPE(X.shape[1], 2, taps=4, delay=2),
    )
    r["wpe-cascade"] = last4_sir(refs, est, n)
    for taps, mode in ((4, "solve"), (4, "steer")):
        est = run_stream(
            X, n,
            lambda F, M, t=taps, u=mode: OnlineTISS(
                F, M, taps=t, delay=2, forget=FORGET, n_pass=2,
                tap_update=u,
            ),
        )
        r[f"t{taps}-{mode}"] = last4_sir(refs, est, n)
    print(
        f"seed {seed}: "
        + "  ".join(f"{k} {v:5.2f}" for k, v in r.items()),
        flush=True,
    )
