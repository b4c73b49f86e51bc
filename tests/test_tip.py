"""T-IP (joint dereverberation + separation, exact IP rows): oracle
invariants (AuxIVA degeneration, surrogate descent), warm-start behavior,
JAX parity, batch/sharded consistency, reverberant-scene quality
(derivation: overiva_jax/oracle/tip.py)."""

import numpy as np
import pytest

import overiva_jax.oracle as oracle
from overiva_jax import api
from overiva_jax.oracle.models import activations
from overiva_jax.oracle.wpe import delayed_taps

from helpers import make_mixture, stft_mixture


@pytest.fixture(scope="module")
def mixture23():
    rng = np.random.default_rng(37)
    mix, premix, _ = make_mixture(
        rng, n_src=2, n_mics=3, n_samples=14000, n_taps=200, snr_db=25
    )
    return stft_mixture(mix, nfft=256).astype(np.complex128)


def test_oracle_taps0_is_auxiva(mixture23):
    """taps=0, N=M: exactly the AuxIVA IP trajectory (cold start)."""
    X = mixture23
    np.testing.assert_array_equal(
        oracle.tip(X, taps=0, n_iter=5), oracle.auxiva(X, n_iter=5)
    )


def test_oracle_surrogate_monotone(mixture23):
    """Each T-IP row update exactly minimizes the MM surrogate over the
    full augmented row, so the objective descends per epoch (from the
    warm-start point on)."""
    X = mixture23[:, :, :2]
    taps, delay = 3, 2
    Xt = np.concatenate([X, delayed_taps(X, taps, delay)], axis=2)
    M = X.shape[2]

    def cost(P):
        Y = np.einsum("fnj,tfj->tfn", P, Xt)
        r, _ = activations(Y, "laplace")
        _, logdet = np.linalg.slogdet(P[:, :, :M])
        return float(np.sum(np.mean(r, axis=0)) - 2 * np.sum(logdet))

    costs = [
        cost(
            oracle.tip(
                X, taps=taps, delay=delay, n_iter=n, warm_iter=2,
                proj_back=False, return_filters=True,
            )[1]
        )
        for n in range(1, 6)
    ]
    assert all(costs[k + 1] <= costs[k] + 1e-6 for k in range(len(costs) - 1)), costs


def test_jax_parity_c128(mixture23):
    X = mixture23
    Yo, Po = oracle.tip(
        X, n_src=2, taps=3, delay=2, n_iter=4, warm_iter=3,
        return_filters=True,
    )
    Yj, Pj = api.tip(
        X, n_src=2, taps=3, delay=2, n_iter=4, warm_iter=3,
        return_filters=True, dtype=np.complex128,
    )
    np.testing.assert_allclose(Pj, Po, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(Yj, Yo, rtol=1e-6, atol=1e-8)


def test_w0_skips_warm_start(mixture23):
    """An explicit W0 bypasses the warm-up (warm-start only fills the
    no-init case)."""
    X = mixture23
    _, P0 = oracle.tip(
        X, n_src=2, taps=2, delay=1, n_iter=2, return_filters=True
    )
    Yo = oracle.tip(
        X, n_src=2, taps=2, delay=1, n_iter=1, W0=P0, warm_iter=10
    )
    Yj = api.tip(
        X, n_src=2, taps=2, delay=1, n_iter=1, W0=P0, warm_iter=10,
        dtype=np.complex128,
    )
    np.testing.assert_allclose(Yj, Yo, rtol=1e-6, atol=1e-8)


def test_batch_matches_single(mixture23):
    X = mixture23
    Xb = np.stack([X, 0.7 * X])
    Yb = api.tip_batch(
        Xb, n_src=2, taps=2, delay=1, n_iter=3, warm_iter=2,
        dtype=np.complex128,
    )
    for b, scale in enumerate((1.0, 0.7)):
        Yref = api.tip(
            scale * X, n_src=2, taps=2, delay=1, n_iter=3, warm_iter=2,
            dtype=np.complex128,
        )
        np.testing.assert_allclose(Yb[b], Yref, rtol=1e-8, atol=1e-10)


def test_wcov_tiers(mixture23):
    """wcov="bf16"/"f32x3" run finite and land near the f32 path on a
    well-conditioned mixture (serving tiers — ops/covariance.py; exact
    parity stays on the default f32)."""
    X = mixture23.astype(np.complex64)
    Yf = api.tip(X, n_src=2, taps=2, delay=1, n_iter=3, warm_iter=2)
    with pytest.raises(ValueError):
        api.tip(X, wcov="fp8")
    for mode in ("f32x3", "bf16"):
        Ym = api.tip(
            X, n_src=2, taps=2, delay=1, n_iter=3, warm_iter=2, wcov=mode
        )
        assert np.isfinite(Ym).all(), mode
        # energy-level agreement (trajectories may diverge slightly)
        rel = np.linalg.norm(Ym - Yf) / np.linalg.norm(Yf)
        assert rel < (0.02 if mode == "f32x3" else 0.3), (mode, rel)


def test_validation_and_registry():
    X = np.zeros((8, 5, 2), np.complex64)
    with pytest.raises(ValueError):
        api.tip(X, taps=2, delay=0)
    with pytest.raises(ValueError):
        api.tip(X, n_src=3)

    from overiva_jax.registry import applicable, get_algorithm

    spec = get_algorithm("tip")
    assert applicable("tip", 2, 4) and applicable("tip", 2, 2)
    rng = np.random.default_rng(47)
    mix, _, _ = make_mixture(rng, n_src=2, n_mics=3, n_samples=10000, snr_db=25)
    Xm = stft_mixture(mix, nfft=128)
    Y = spec(Xm, n_src=2, n_iter=3, warm_iter=3)
    assert Y.shape == (Xm.shape[0], Xm.shape[1], 2)
    assert np.isfinite(Y).all()


def test_separate_fused_tip_and_ilrma_t():
    """algo="tip" / "ilrma_t" run end-to-end in the fused time pipeline."""
    rng = np.random.default_rng(48)
    mix, _, _ = make_mixture(rng, n_src=2, n_mics=2, n_samples=8000, snr_db=25)
    for algo in ("tip", "ilrma_t"):
        y = api.separate(
            mix, n_src=2, nfft=256, hop=128, n_iter=4, algo=algo,
            taps=2, delay=1,
        )
        assert y.shape == (8000, 2) and np.isfinite(y).all(), algo


def test_sharded_tip_matches_single_device(mixture23):
    import jax

    from overiva_jax.parallel.mesh import make_mesh
    from overiva_jax.parallel.sharded import sharded_tip

    X = mixture23[:40].astype(np.complex64)
    n_bins = min(4, len(jax.devices()))
    mesh = make_mesh(1, n_bins, devices=jax.devices()[:n_bins])
    Yb = np.asarray(
        sharded_tip(
            mesh, X[None], n_src=2, taps=2, delay=1, n_iter=2, warm_iter=2
        )
    )
    Yref = api.tip(
        X, n_src=2, taps=2, delay=1, n_iter=2, warm_iter=2,
        dtype=np.complex64,
    )
    np.testing.assert_allclose(Yb[0], Yref, rtol=2e-3, atol=2e-4)


def test_tip_polish_improves_tiss_on_reverberant_room():
    """The measured claim (docs/DESIGN.md §8): after the T-ISS warm-up, a
    short gauss T-IP polish improves SIR over T-ISS alone on a hard
    reverberant room (window 32 ms << RT60 400 ms tail)."""
    from overiva_jax.metrics.bss_eval import bss_eval_sources
    from overiva_jax.oracle import analysis, stft_pad, synthesis
    from overiva_jax.sim import ShoeBox, circular_mic_array, semi_circle_layout
    from overiva_jax.sim.sources import speech_like

    fs, n = 16000, 16000 * 6
    nfft, hop, seed = 512, 256, 12
    rng = np.random.default_rng(seed)
    room_dim = [7.0, 5.5, 3.0]
    room = ShoeBox(room_dim, fs=fs, rt60=0.4, seed=seed)
    center = np.asarray(room_dim) / 2
    sp = np.clip(
        semi_circle_layout(
            [center[0], center[1], 1.5], np.pi / 2, 2.0, 2,
            rot=rng.uniform(-np.pi, np.pi),
        ),
        0.3,
        np.asarray(room_dim) - 0.3,
    )
    for k in range(2):
        room.add_source(sp[k], speech_like(n, fs, seed=seed * 1009 + k))
    room.add_mic_array(circular_mic_array([center[0], center[1], 1.5], 0.05, 4))
    premix, noise = room.simulate(return_premix=True, snr=30)
    mix = (premix.sum(axis=0) + noise).T[:n]
    refs = premix[:, 0, :n]
    X = analysis(stft_pad(mix, nfft, hop), nfft, hop)

    def mean_sir(Y):
        y = synthesis(np.asarray(Y), nfft, hop)[:n]
        _, sir, _, _ = bss_eval_sources(refs, y.T)
        return sir.mean()

    sir_tiss = mean_sir(api.tiss(X, n_src=2, taps=4, delay=2, n_iter=30))
    sir_tip = mean_sir(
        api.tip(
            X, n_src=2, taps=4, delay=2, n_iter=10, warm_iter=10,
            model="gauss",
        )
    )
    # measured on this seed: tiss 11.15, warm tip-gauss 11.40 (seeds 3/5:
    # 6.01->7.05, 9.67->10.42); assert with slack for platform noise
    assert sir_tip > sir_tiss - 0.5, (sir_tiss, sir_tip)
    assert sir_tip > 8.0, sir_tip

def test_callback_path_matches_plain(mixture23):
    """The chunked callback path (api._tip_chunk, with its per-chunk
    background-pieces hoist) must be trajectory-identical to the fused
    no-callback run."""
    X = mixture23
    Y_plain = api.tip(
        X, n_src=2, taps=2, delay=1, n_iter=4, warm_iter=2,
        dtype=np.complex128,
    )
    snaps = []
    Y_cb = api.tip(
        X, n_src=2, taps=2, delay=1, n_iter=4, warm_iter=2,
        dtype=np.complex128, callback=lambda y: snaps.append(y),
        callback_every=2,
    )
    assert len(snaps) == 2
    np.testing.assert_allclose(Y_cb, Y_plain, rtol=1e-10, atol=1e-12)
