"""T-IP stage budget: where does the registry-default T-IP program's time go?

Decomposes the registry-default T-IP program (10 warm T-ISS epochs + 10
exact T-IP epochs at T=512, taps=5, M=8 -> N=3, F=2049, MJ=48) into its
stages, the way DESIGN §2c budgets the OverIVA epoch and §8 the T-ISS
tap scan.

Stages are chained through the activations (each probe feeds a phi
derived from its own previous output) so XLA cannot hoist repeated work
out of the fori_loop, mirroring the docs/DESIGN.md §2c probe methodology. Per-epoch stage
set (for the N=3 target rows; the background rows' pieces are
run-constant and hoisted — models/tip.py):

  demix+phi   demix of the N target rows + power + activations
  wcov        the MJ-dim weighted covariance, one per target row
  schur       C = solve(V22, V21) (L=40-dim) + S = V11 - V12 C
  solve       AS = P_top S, the M-dim row solve, w2 back-substitution
  norm        the data normalizer: yk = w^H x_tilde over (T, F, MJ) + clamp

    python bench/exp_tip_budget.py
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from overiva_jax.utils.cache import enable_persistent_cache

enable_persistent_cache()

import jax
import jax.numpy as jnp

from overiva_jax.models.tip import _schur_pieces, tip_iterations
from overiva_jax.models.tiss import augment_taps, augmented_eye, tiss_iterations
from overiva_jax.models.overiva import demix
from overiva_jax.models.source_models import activations_from_power, power
from overiva_jax.ops.covariance import weighted_covariance_all
from overiva_jax.ops.linalg import PRECISION, clamp_pow2, gauss_solve

T, F, M, N, TAPS, DELAY = 512, 2049, 8, 3, 5, 2
EPOCHS = 10

def timed(thunk, repeats=3):
    jax.block_until_ready(thunk())
    best = np.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(thunk())
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    rng = np.random.default_rng(0)
    re = rng.standard_normal((T, F, M)).astype(np.float32)
    im = rng.standard_normal((T, F, M)).astype(np.float32)
    gate = np.where(rng.random(T) < 0.5, 1.0, 0.1).astype(np.float32)
    re *= gate[:, None, None]
    im *= gate[:, None, None]
    X = jax.jit(lambda r, i: r + 1j * i)(re, im)
    Xt = jax.jit(lambda x: augment_taps(x, TAPS, DELAY))(X)
    P0 = jax.jit(lambda xt: augmented_eye(xt, M))(Xt)
    MJ = M * (1 + TAPS)

    # --- the two program halves -------------------------------------
    warm_jit = jax.jit(
        lambda xt, p: tiss_iterations(xt, p, EPOCHS, "laplace", M, n_src=N)[0]
    )
    t_warm = timed(lambda: warm_jit(Xt, P0))
    P1 = warm_jit(Xt, P0)
    tip_jit = jax.jit(
        lambda xt, p: tip_iterations(xt, p, EPOCHS, "laplace", M, n_src=N)
    )
    t_tip = timed(lambda: tip_jit(Xt, P1))
    full_jit = jax.jit(
        lambda xt, p: tip_iterations(
            xt, tiss_iterations(xt, p, EPOCHS, "laplace", M, n_src=N)[0],
            EPOCHS, "laplace", M, n_src=N,
        )
    )
    t_full = timed(lambda: full_jit(Xt, P0))
    print(f"warm 10 T-ISS epochs : {t_warm*1e3:8.1f} ms")
    print(f"10 T-IP epochs       : {t_tip*1e3:8.1f} ms")
    print(f"full default program : {t_full*1e3:8.1f} ms  (bench row minus STFT)")

    # --- staged T-IP epoch probes (phi-chained fori loops) -----------
    # each probe runs EPOCHS iterations of an epoch truncated after a
    # stage; the truncated epoch must still produce something phi-feeds
    # on, so every stage folds a scalar of its output back into P's
    # scale (a no-op multiply near 1) to chain the loop.

    def chain(P, val):
        # fold a data-dependent scalar ~0 into P so the next iteration
        # depends on this one's work (prevents hoisting) without
        # changing the numerics: 1.0 + |val|*1e-30 rounds to exactly 1.0
        # in f32 at runtime, but is not statically foldable the way a
        # literal *0.0 is (XLA's simplifier dead-codes that whole chain
        # — measured on the wcov micro-bench, bench/exp_wcov_tiers.py)
        eps = (jnp.abs(jnp.real(val)) * 1e-30).astype(P.real.dtype)
        return P * (1.0 + jnp.minimum(eps, 1e-30))

    def probe(stage):
        # Xt enters as a jit ARGUMENT: closure capture would embed the
        # complex tensor in the program as a constant.
        def epoch(Xt, _, P):
            Y = demix(Xt, P[:, :N, :])
            pw = power(Y)
            _, phi = activations_from_power(pw, F, "laplace")
            phif = phi.astype(jnp.float32)
            if stage == "demix+phi":
                return chain(P, jnp.sum(phif))
            acc = jnp.zeros((), Xt.dtype)
            for k in range(N):
                V = weighted_covariance_all(Xt, phif[:, k : k + 1], "f32")[0]
                if stage == "wcov":
                    acc = acc + jnp.sum(V[:, 0, 0])
                    continue
                C, S = _schur_pieces(V, M)
                if stage == "schur":
                    acc = acc + jnp.sum(S[:, 0, 0]) + jnp.sum(C[:, 0, 0])
                    continue
                AS = jnp.matmul(P[:, :, :M], S, precision=PRECISION)
                rhs = jnp.zeros((F, M, 1), Xt.dtype).at[:, k, 0].set(1.0)
                w1 = gauss_solve(AS, rhs)[:, :, 0]
                w2 = -jnp.einsum("flm,fm->fl", C, w1, precision=PRECISION)
                w = clamp_pow2(jnp.concatenate([w1, w2], axis=1))
                if stage == "solve":
                    acc = acc + jnp.sum(w[:, 0])
                    continue
                yk = jnp.einsum(
                    "fa,tfa->tf", jnp.conj(w), Xt, precision=PRECISION
                )
                denom = (
                    jnp.einsum("t,tf->f", phif[:, k], jnp.abs(yk) ** 2,
                               precision=PRECISION) / T
                )
                acc = acc + jnp.sum(denom).astype(Xt.dtype)
            return chain(P, acc)

        return jax.jit(
            lambda xt, p: jax.lax.fori_loop(
                0, EPOCHS, lambda i, pp: epoch(xt, i, pp), p
            )
        )

    prev = 0.0
    for stage in ("demix+phi", "wcov", "schur", "solve", "norm"):
        fn = probe(stage)
        t = timed(lambda: fn(Xt, P1))
        print(f"  +{stage:10s}: {t*1e3:8.1f} ms  (marginal {(t-prev)*1e3:+7.1f})")
        prev = t


if __name__ == "__main__":
    main()
