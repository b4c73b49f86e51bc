"""End-to-end integration: full pipeline (time -> STFT -> separate -> iSTFT ->
bss_eval) for every BASELINE.json config, with the 0.1 dB SDR/SIR parity gate
between the complex64 JAX path and the float64 NumPy oracle
(BASELINE.json:2,5; SURVEY.md §4, §6)."""

import numpy as np
import pytest

import overiva_jax.oracle as oracle
from overiva_jax import api
from overiva_jax.metrics import bss_eval_sources

from helpers import make_mixture


def pipeline(separate, mix, premix, nfft, n_out=None):
    """mix (n, M) -> separated time signals + SDR/SIR vs the mic-0 images."""
    hop = nfft // 2
    xp = oracle.stft_pad(mix, nfft, hop)
    X = oracle.analysis(xp, nfft, hop)
    Y = separate(X)
    y = oracle.synthesis(Y, nfft, hop)
    start = nfft - hop
    y = y[start : start + mix.shape[0]]
    n_out = n_out or premix.shape[0]
    refs = premix[:, :, 0]  # images at mic 0
    if n_out == refs.shape[0]:
        sdr, sir, _, perm = bss_eval_sources(refs, y.T)
        return sdr, sir
    # single-output (OGIVE): score vs best-matching reference
    best = None
    for j in range(refs.shape[0]):
        pair_refs = np.stack([refs[j], refs.sum(0) - refs[j]])
        est = np.stack([y[:, 0], mix[:, 0] - y[:, 0]])
        sdr, sir, _, _ = bss_eval_sources(pair_refs, est, compute_permutation=False)
        if best is None or sdr[0] > best[0][0]:
            best = (sdr, sir)
    return best


def parity_case(mix, premix, sep_oracle, sep_jax, nfft, n_out=None, tol=0.1):
    sdr_o, sir_o = pipeline(sep_oracle, mix, premix, nfft, n_out)
    sdr_j, sir_j = pipeline(sep_jax, mix, premix, nfft, n_out)
    assert np.max(np.abs(sdr_j - sdr_o)) < tol, (sdr_j, sdr_o)
    assert np.max(np.abs(sir_j - sir_o)) < tol, (sir_j, sir_o)
    return sdr_o, sir_o


def test_config1_auxiva_determined_2x2():
    """BASELINE config 1: auxiva (Laplace), M=N=2, 512-pt STFT."""
    rng = np.random.default_rng(101)
    mix, premix, _ = make_mixture(rng, n_src=2, n_mics=2, n_samples=24000)
    sdr, sir = parity_case(
        mix, premix,
        lambda X: oracle.auxiva(X, n_iter=20),
        lambda X: api.auxiva(X, n_iter=20),
        nfft=512,
    )
    # separation must actually work: mixture SIR at mic0 is ~0 dB
    assert np.min(sir) > 8.0, sir


def test_config2_overiva_5x2():
    """BASELINE config 2: overiva M=5, N=2, OC background + projection back."""
    rng = np.random.default_rng(102)
    mix, premix, _ = make_mixture(rng, n_src=2, n_mics=5, n_samples=24000, snr_db=25)
    sdr, sir = parity_case(
        mix, premix,
        lambda X: oracle.overiva(X, n_src=2, n_iter=20),
        lambda X: api.overiva(X, n_src=2, n_iter=20),
        nfft=256,
    )
    assert np.min(sir) > 8.0, sir


def test_config3_ogive_single_source():
    """BASELINE config 3: ogive gradient extraction, M mics, N=1."""
    rng = np.random.default_rng(103)
    mix, premix, _ = make_mixture(rng, n_src=2, n_mics=4, n_samples=20000, snr_db=25)
    premix[0] *= 2.5  # dominant target
    mix = premix.sum(axis=0)
    (sdr_o, sir_o) = pipeline(
        lambda X: oracle.ogive(X, n_iter=60, step_size=0.05, tol=0),
        mix, premix, 256, n_out=1,
    )
    (sdr_j, sir_j) = pipeline(
        lambda X: api.ogive(X, n_iter=60, step_size=0.05, tol=0),
        mix, premix, 256, n_out=1,
    )
    assert abs(sdr_j[0] - sdr_o[0]) < 0.1, (sdr_j, sdr_o)
    assert sir_j[0] > 5.0


@pytest.mark.parametrize("algo,kwargs", [
    ("auxiva-gauss", {}),
    ("overiva-gauss", {}),
])
def test_config4_gauss_variants(algo, kwargs):
    """BASELINE config 4: time-varying Gauss model variants."""
    rng = np.random.default_rng(104)
    if algo == "auxiva-gauss":
        mix, premix, _ = make_mixture(rng, n_src=2, n_mics=2, n_samples=24000, snr_db=25)
        sdr, sir = parity_case(
            mix, premix,
            lambda X: oracle.auxiva(X, n_iter=20, model="gauss"),
            lambda X: api.auxiva(X, n_iter=20, model="gauss"),
            nfft=256,
        )
    else:
        mix, premix, _ = make_mixture(rng, n_src=2, n_mics=5, n_samples=24000, snr_db=20)
        sdr, sir = parity_case(
            mix, premix,
            lambda X: oracle.overiva(X, n_src=2, n_iter=20, model="gauss"),
            lambda X: api.overiva(X, n_src=2, n_iter=20, model="gauss"),
            nfft=256,
        )
    assert np.min(sir) > 6.0, sir


@pytest.mark.parametrize("seed", [211, 212, 213])
def test_parity_gate_across_seeds(seed):
    """The 0.1 dB gate is not a single-seed accident (config 2 shape)."""
    rng = np.random.default_rng(seed)
    mix, premix, _ = make_mixture(rng, n_src=2, n_mics=5, n_samples=20000, snr_db=25)
    parity_case(
        mix, premix,
        lambda X: oracle.overiva(X, n_src=2, n_iter=15),
        lambda X: api.overiva(X, n_src=2, n_iter=15),
        nfft=256,
    )


def test_auxiva_pca_pipeline():
    rng = np.random.default_rng(105)
    mix, premix, _ = make_mixture(rng, n_src=2, n_mics=5, n_samples=24000, snr_db=25)
    sdr, sir = parity_case(
        mix, premix,
        lambda X: oracle.auxiva_pca(X, n_src=2, n_iter=20),
        lambda X: api.auxiva_pca(X, n_src=2, n_iter=20),
        nfft=256,
        # round 2: back at the 0.1 dB gate — the PCA bases are now
        # phase-aligned deterministically in both backends
    )
    assert np.min(sir) > 6.0, sir


@pytest.mark.parametrize("model,seed", [
    ("gauss", 104), ("gauss", 212), ("laplace", 102),
])
def test_same_precision_parity_gate(model, seed):
    """oracle-c64 vs JAX-c64 at 0.02 dB: the 0.1 dB
    c64-vs-f64 gate has only ~0.013 dB of implementation headroom left on
    overiva-gauss (the rest is the intrinsic precision floor, PARITY.md
    round-2 decomposition), so implementation drift is gated here at the
    SAME precision, where it cannot hide inside the c64 rounding cost."""
    rng = np.random.default_rng(seed)
    mix, premix, _ = make_mixture(
        rng, n_src=2, n_mics=5, n_samples=24000,
        snr_db=20 if model == "gauss" else 25,
    )
    parity_case(
        mix, premix,
        lambda X: oracle.overiva(
            X.astype(np.complex64), n_src=2, n_iter=20, model=model
        ),
        lambda X: api.overiva(X, n_src=2, n_iter=20, model=model),
        nfft=256,
        tol=0.02,
    )
