"""Diagnose the overiva-gauss c64 parity floor.

Runs the NumPy oracle at c64 with SELECTED stages promoted to f64, to find
which per-epoch rounding source drives the 0.110 dB f64-vs-c64 floor:

  A  f64 oracle (truth)
  B  c64 everywhere (the known floor)
  C  c64 + f64 activation chain (demix -> power -> r -> phi), phi cast f32
  C2 c64 + f64 activation chain, phi KEPT f64 in the V einsum
  D  C + f64 IP normalizer (w^H V w)
  E  D + f64 IP solve (WV formed and solved in c128, result cast back)
  F  everything f64 except input cast to c64 first (input-quantization-only)

All CPU NumPy. Reports |dSDR|,|dSIR| vs A per seed.
"""
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import overiva_jax.oracle as oracle
from overiva_jax.metrics import bss_eval_sources
from overiva_jax.oracle.models import EPS, REL_EPS
from overiva_jax.oracle.projection import projection_back
from overiva_jax.sim import (
    ShoeBox,
    circular_mic_array,
    semi_circle_layout,
    speech_like,
)


def overiva_variant(X, n_src, n_iter, model="gauss", f64_act=False,
                    phi_f64=False, f64_norm=False, f64_solve=False):
    X = np.asarray(X)
    T, F, M = X.shape
    N = n_src
    Cx = np.einsum("tfm,tfn->fmn", X, np.conj(X)) / T
    W_hat = np.tile(np.eye(M, dtype=X.dtype), (F, 1, 1))
    if N < M:
        W_hat[:, N:, N:] = -np.eye(M - N, dtype=X.dtype)

    def update_J():
        W1 = W_hat[:, :N, :]
        tmp = W1 @ Cx
        J_H = np.linalg.solve(tmp[:, :, :N], tmp[:, :, N:])
        W_hat[:, N:, :N] = np.conj(np.swapaxes(J_H, 1, 2))

    if N < M:
        update_J()

    eyes = np.tile(np.eye(M, dtype=X.dtype), (F, 1, 1))
    X64 = X.astype(np.complex128) if (f64_act or phi_f64) else None
    for _ in range(n_iter):
        W1 = W_hat[:, :N, :]
        if f64_act:
            Y = np.einsum("fnm,tfm->tfn", W1.astype(np.complex128), X64)
            pw = np.sum(np.abs(Y) ** 2, axis=1)  # f64 (T, N)
        else:
            Y = np.einsum("fnm,tfm->tfn", W1, X)
            pw = np.sum(np.abs(Y) ** 2, axis=1)
        if model == "gauss":
            r = pw / F
        else:
            r = 2.0 * np.sqrt(pw)
        r = np.maximum(r, EPS)
        r = np.maximum(r, REL_EPS * np.max(r, axis=0, keepdims=True))
        phi = 1.0 / r
        if f64_act and not phi_f64:
            phi = phi.astype(np.float32)

        for k in range(N):
            phik = phi[:, k].astype(X.real.dtype if not phi_f64 else np.float64)
            if phi_f64:
                V = (np.einsum("t,tfm,tfn->fmn", phik, X64, np.conj(X64)) / T
                     ).astype(X.dtype)
            else:
                V = np.einsum("t,tfm,tfn->fmn", phik, X, np.conj(X)) / T
            if f64_solve:
                WV = W_hat.astype(np.complex128) @ V.astype(np.complex128)
                w = np.linalg.solve(
                    WV, eyes[:, :, k : k + 1].astype(np.complex128)
                )[:, :, 0]
            else:
                WV = W_hat @ V
                w = np.linalg.solve(WV, eyes[:, :, k : k + 1])[:, :, 0]
            if f64_norm or f64_solve:
                denom = np.einsum(
                    "fm,fmn,fn->f",
                    np.conj(w).astype(np.complex128),
                    V.astype(np.complex128),
                    w.astype(np.complex128),
                )
                w = (w / np.sqrt(np.real(denom))[:, None]).astype(X.dtype)
            else:
                denom = np.einsum("fm,fmn,fn->f", np.conj(w), V, w)
                w = w / np.sqrt(np.real(denom))[:, None]
            W_hat[:, k, :] = np.conj(w)
            if N < M:
                update_J()

    Y = np.einsum("fnm,tfm->tfn", W_hat[:, :N, :], X)
    z = projection_back(Y, X[:, :, 0])
    return Y * np.conj(z)[None, :, :]


def run(separate, mix, premix, nfft=1024):
    hop = nfft // 2
    X = oracle.analysis(oracle.stft_pad(mix, nfft, hop), nfft, hop)
    Y = separate(X)
    y = oracle.synthesis(np.asarray(Y, dtype=np.complex128), nfft, hop)[
        nfft - hop :
    ][: mix.shape[0]]
    refs = premix[:, 0, : mix.shape[0]]
    sdr, sir, _, _ = bss_eval_sources(refs, y.T)
    return sdr, sir


def main():
    seeds = [int(s) for s in sys.argv[1:]] or [7]
    n_iter, model = 15, "gauss"
    for seed in seeds:
        fs, n = 16000, 64000
        room = ShoeBox([7.0, 6.0, 3.0], fs=fs, rt60=0.22, seed=seed)
        for k, pos in enumerate(
            semi_circle_layout([3.5, 3.0, 1.5], np.pi / 2, 2.2, 2, rot=np.pi / 2)
        ):
            room.add_source(pos, speech_like(n, fs, seed=seed * 13 + k))
        room.add_mic_array(circular_mic_array([3.5, 3.0, 1.5], 0.05, 5))
        premix, noise = room.simulate(return_premix=True, snr=25.0)
        mix = (premix.sum(axis=0) + noise).T[:n]

        hop = 512
        X = oracle.analysis(oracle.stft_pad(mix, 1024, hop), 1024, hop)
        Xc = X.astype(np.complex64)

        sep = lambda Xin, **kw: overiva_variant(Xin, 2, n_iter, model, **kw)
        variants = {
            "A_f64": lambda: run(lambda _: sep(X), mix, premix),
            "B_c64": lambda: run(lambda _: sep(Xc), mix, premix),
            "C_f64_act": lambda: run(
                lambda _: sep(Xc, f64_act=True), mix, premix),
            "C2_f64_act_phi": lambda: run(
                lambda _: sep(Xc, f64_act=True, phi_f64=True), mix, premix),
            "D_plus_norm": lambda: run(
                lambda _: sep(Xc, f64_act=True, phi_f64=True, f64_norm=True),
                mix, premix),
            "E_plus_solve": lambda: run(
                lambda _: sep(Xc, f64_act=True, phi_f64=True, f64_norm=True,
                              f64_solve=True), mix, premix),
            "F_quant_only": lambda: run(
                lambda _: sep(Xc.astype(np.complex128)), mix, premix),
        }
        ref = None
        print(f"=== seed {seed} ===")
        for name, fn in variants.items():
            sdr, sir = fn()
            if ref is None:
                ref = (sdr, sir)
                print(f"{name:16s} SDR {sdr} SIR {sir}")
            else:
                dsdr = float(np.max(np.abs(sdr - ref[0])))
                dsir = float(np.max(np.abs(sir - ref[1])))
                print(f"{name:16s} |dSDR| {dsdr:.4f}  |dSIR| {dsir:.4f}")


if __name__ == "__main__":
    main()
