"""Weighted-covariance tiers and the OverIVA epoch on the accelerator.

Times, at the headline shape (F=2049 bins, M=8 mics, N=3 sources):

- the full OverIVA epoch (marginal time per epoch of ``overiva_iterations``
  at wcov = f32 / f32x3 / bf16, from a 130-epoch and a 30-epoch program);
- the ``weighted_covariance_all`` stage alone at each tier;
- each tier's accuracy: max|V - V_ref| / max|V_ref| against the f32 tier
  and against a float64 NumPy reference;
- what ``lax.Precision`` DEFAULT / HIGH / HIGHEST give for a plain float32
  matrix product on this backend (relative error against float64), which
  tells whether HIGH runs as TF32 (~1e-3) or as three bf16 passes (~1e-6).

Stage timing: ``lax.scan`` over a stack of DISTINCT phi vectors,
accumulating a scalar of each V, so every step's work feeds the output (no
dead-code elimination) and no two steps share a phi (no hoisting).

    python bench/exp_wcov_tiers.py [--frames 128 512]

Prints one line per measurement with the device it ran on.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
from jax import lax

from overiva_jax.api import _prepare
from overiva_jax.models.overiva import overiva_iterations
from overiva_jax.ops.covariance import weighted_covariance_all
from overiva_jax.utils.cache import enable_persistent_cache

F, M, N = 2049, 8, 3
REPS = 20
TIERS = ("f32", "f32x3", "bf16")


def timed(thunk, repeats=5):
    """Median wall time of ``thunk`` after one warm-up call."""
    jax.block_until_ready(thunk())
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(thunk())
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def precision_probe(n=1024):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    for p in ("DEFAULT", "HIGH", "HIGHEST"):
        prec = getattr(lax.Precision, p)
        fn = jax.jit(lambda x, y, q=prec: jnp.matmul(x, y, precision=q))
        out = np.asarray(fn(a, b), np.float64)
        hlo = fn.lower(a, b).compile().as_text()
        for line in hlo.splitlines():
            if "custom_call_target" in line or "algorithm" in line:
                print(f"  {p} compiled: {line.strip()[:400]}")
        err = np.abs(out - ref).max() / np.abs(ref).max()
        print(f"precision {p:8s} f32 matmul {n}x{n}: max rel err {err:.3e}")
        ac = a + 1j * b
        fnc = jax.jit(lambda x, q=prec: jnp.einsum(
            "ij,jk->ik", x, jnp.conj(x), precision=q))
        refc = ac.astype(np.complex128) @ np.conj(ac.astype(np.complex128))
        outc = np.asarray(fnc(ac.astype(np.complex64)), np.complex128)
        errc = np.abs(outc - refc).max() / np.abs(refc).max()
        print(f"precision {p:8s} c64 matmul {n}x{n}: max rel err {errc:.3e}")


def make_mix(rng, T):
    re = rng.standard_normal((T, F, M)).astype(np.float32)
    im = rng.standard_normal((T, F, M)).astype(np.float32)
    gate = np.where(rng.random(T) < 0.5, 1.0, 0.1).astype(np.float32)
    return (re + 1j * im) * gate[:, None, None]


def frames_row(T):
    rng = np.random.default_rng(T)
    Xn = make_mix(rng, T)
    X = jnp.asarray(Xn)
    phis_n = rng.random((REPS, T, N)).astype(np.float32) + 0.1
    phis = jnp.asarray(phis_n)

    # accuracy against f32 and against a float64 reference, on phis[0]
    V64 = np.einsum("tk,tfm,tfn->kfmn", phis_n[0].astype(np.float64),
                    Xn.astype(np.complex128), np.conj(Xn)) / T
    wc = jax.jit(weighted_covariance_all, static_argnames=("wcov",))
    V = {t: np.asarray(wc(X, phis[0], wcov=t), np.complex128) for t in TIERS}
    scale = np.abs(V64).max()

    W_hat, Cx = _prepare(X, X[:0], N, False, True, False)
    for tier in TIERS:

        def stack(x, phs, tier=tier):
            def body(acc, ph):
                Vk = weighted_covariance_all(x, ph, tier)
                return acc + jnp.real(Vk[0][:, 0, 0].sum()), None

            return lax.scan(body, jnp.float32(0.0), phs)[0]

        fn = jax.jit(stack)
        t_stage = timed(lambda: fn(X, phis)) / REPS
        t30 = timed(lambda: overiva_iterations(X, W_hat, Cx, N, 30, "laplace",
                                               wcov=tier))
        t130 = timed(lambda: overiva_iterations(X, W_hat, Cx, N, 130,
                                                "laplace", wcov=tier))
        e32 = np.abs(V[tier] - V["f32"]).max() / scale
        e64 = np.abs(V[tier] - V64).max() / scale
        print(f"T={T} wcov={tier:5s}: epoch {(t130 - t30) / 100 * 1e3:.4f} ms "
              f"(marginal), 30-epoch call {t30 * 1e3:.3f} ms, "
              f"weighted_covariance_all {t_stage * 1e3:.4f} ms, "
              f"err vs f32 {e32:.3e}, vs f64 {e64:.3e}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, nargs="+", default=[128, 512])
    args = ap.parse_args()
    enable_persistent_cache()
    d = jax.devices()[0]
    print(f"device: {d.platform} {d.device_kind} x{len(jax.devices())}")
    precision_probe()
    for T in args.frames:
        frames_row(T)


if __name__ == "__main__":
    main()
