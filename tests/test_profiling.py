"""Observability utilities: timers, device waits, convergence recorder."""

import numpy as np

from overiva_jax import api
from overiva_jax.oracle import analysis, stft_pad
from overiva_jax.utils.profiling import ConvergenceRecorder, PhaseTimer

from helpers import make_mixture


def test_phase_timer_accumulates():
    t = PhaseTimer()
    with t("a"):
        pass
    with t("a"):
        pass
    with t("b"):
        pass
    assert t.counts["a"] == 2 and t.counts["b"] == 1
    assert "a" in t.report()
    d = t.as_dict()
    assert d["a"]["count"] == 2


def test_phase_timer_sync_blocks_until_ready(monkeypatch):
    """sync_on waits through jax.block_until_ready, before the clock stops,
    on every array of the pytree it is given (complex included)."""
    import jax
    import jax.numpy as jnp

    seen = []
    real = jax.block_until_ready

    def spy(x):
        seen.append(x)
        return real(x)

    monkeypatch.setattr(jax, "block_until_ready", spy)
    out = (jnp.ones((4,)), jnp.ones((4,)) + 1j * jnp.ones((4,)))
    t = PhaseTimer()
    with t("run", sync_on=out):
        pass
    with t("free"):
        pass
    assert len(seen) == 1 and seen[0] is out
    assert t.counts["run"] == 1 and t.counts["free"] == 1


def test_convergence_recorder_improves():
    rng = np.random.default_rng(41)
    nfft, hop = 256, 128
    mix, premix, _ = make_mixture(rng, n_src=2, n_mics=2, n_samples=20000, snr_db=25)
    X = analysis(stft_pad(mix, nfft, hop), nfft, hop)
    rec = ConvergenceRecorder(premix[:, :, 0], nfft, n_samples=mix.shape[0])
    api.auxiva(X, n_iter=21, callback=rec, callback_every=10)
    assert len(rec.sir) == 3
    # separation quality should improve from the first to the last snapshot
    assert np.mean(rec.sir[-1]) > np.mean(rec.sir[0]) + 3.0
