"""bss_eval property tests (SURVEY.md §7.4 hard part #1)."""

import numpy as np
import pytest

from overiva_jax.metrics.bss_eval import (
    BssEvalReferences,
    bss_eval_images,
    bss_eval_sources,
)


@pytest.fixture
def sources(rng):
    n = 8000
    s = rng.laplace(size=(3, n))
    # distinct coloration
    for k in range(3):
        s[k] = np.convolve(s[k], [1.0, 0.4 * (-1) ** k, 0.1 * k], "same")
    return s


def test_perfect_estimate(sources):
    sdr, sir, sar, perm = bss_eval_sources(sources, sources.copy())
    assert np.all(sdr > 100)
    assert np.all(sir > 100)
    np.testing.assert_array_equal(perm, [0, 1, 2])


def test_filtered_estimate_counts_as_target(sources, rng):
    """A <512-tap filtered ref is allowed distortion under the 512-tap
    projection (up to a small conv-tail truncation edge effect), but NOT
    under a 1-tap projection."""
    h = rng.standard_normal(64) * np.exp(-np.arange(64) / 8)
    est = np.stack([np.convolve(s, h, "full")[: sources.shape[1]] for s in sources])
    sdr, sir, sar, perm = bss_eval_sources(sources, est)
    assert np.all(sdr > 25)
    np.testing.assert_array_equal(perm, [0, 1, 2])
    sdr1, *_ = bss_eval_sources(sources, est, filter_length=1)
    assert np.all(sdr - sdr1 > 20), (sdr, sdr1)


def test_noise_sets_sdr(sources, rng):
    """est = ref + white noise at known SNR -> SDR ~= SNR, SAR ~= SNR, SIR huge."""
    target_snr = 10.0
    s0 = sources[:1]
    noise = rng.standard_normal(s0.shape)
    noise *= np.linalg.norm(s0) / np.linalg.norm(noise) * 10 ** (-target_snr / 20)
    est = s0 + noise
    sdr, sir, sar, _ = bss_eval_sources(s0, est)
    assert abs(sdr[0] - target_snr) < 1.0
    assert abs(sar[0] - target_snr) < 1.0
    assert sir[0] > 100  # single ref: no interference term


def test_interference_sets_sir(sources):
    """est = ref0 + g*ref1 -> SIR ~= -20 log10 g."""
    g = 10 ** (-15 / 20)  # -15 dB interference
    est = np.stack([sources[0] + g * sources[1], sources[1], sources[2]])
    sdr, sir, sar, perm = bss_eval_sources(sources, est)
    np.testing.assert_array_equal(perm, [0, 1, 2])
    assert abs(sir[0] - 15.0) < 1.0
    assert abs(sdr[0] - 15.0) < 1.0
    assert sar[0] > 60  # mixture of refs only: no artifacts


def test_permutation_recovered(sources):
    est = sources[[2, 0, 1]]  # estimate 0 is source 2, est 1 is src 0, est 2 is src 1
    sdr, sir, sar, perm = bss_eval_sources(sources, est)
    # mir_eval convention: perm[j] = index of the estimate matching reference j
    np.testing.assert_array_equal(perm, [1, 2, 0])
    assert np.all(sdr > 100)


def test_zero_estimate_scores_negative_inf(sources):
    """An all-zero estimate carries no target energy: SDR/SIR must be -inf,
    not the +inf of the zero-residual (perfect-match) branch. Regression for
    the r3c sweep instance where a degenerate separation scored +inf."""
    est = sources.copy()
    est[1] = 0.0
    sdr, sir, _, _ = bss_eval_sources(sources, est)
    assert sdr[1] == -np.inf
    assert sir[1] == -np.inf
    # the healthy rows stay perfect matches
    assert sdr[0] > 100 and sdr[2] > 100


def test_shape_mismatch_raises(sources):
    with pytest.raises(ValueError):
        bss_eval_sources(sources, sources[:2])


def test_silent_reference_raises(sources):
    refs = sources.copy()
    refs[1] = 0.0
    with pytest.raises(ValueError):
        bss_eval_sources(refs, sources)


def test_no_permutation_mode(sources):
    est = sources[[1, 0, 2]]
    sdr, sir, sar, perm = bss_eval_sources(sources, est, compute_permutation=False)
    np.testing.assert_array_equal(perm, [0, 1, 2])
    assert sdr[0] < 10  # mismatched without permutation search


def _explicit_decomposition(refs, ests, flen):
    """Brute-force Vincent-2006 criteria: materialize the delayed-reference
    basis, project with lstsq, and measure actual time-domain energies.
    Ground truth for the production path's quadratic-form energy identities
    (bss_eval.py module docstring)."""
    nsrc, nsampl = refs.shape
    nproj = nsampl + flen - 1
    basis = np.zeros((nproj, nsrc, flen))
    for i in range(nsrc):
        for tau in range(flen):
            basis[tau : tau + nsampl, i, tau] = refs[i]
    A = basis.reshape(nproj, nsrc * flen)
    sdr = np.empty((nsrc, nsrc))
    sir = np.empty((nsrc, nsrc))
    sar = np.empty((nsrc, nsrc))
    for k in range(nsrc):
        e = np.concatenate([ests[k], np.zeros(flen - 1)])
        p_all = A @ np.linalg.lstsq(A, e, rcond=None)[0]
        for j in range(nsrc):
            Aj = basis[:, j, :]
            s_filt = Aj @ np.linalg.lstsq(Aj, e, rcond=None)[0]
            e_interf = p_all - s_filt
            e_artif = e - p_all
            sdr[k, j] = 10 * np.log10(
                np.sum(s_filt**2) / np.sum((e_interf + e_artif) ** 2)
            )
            sir[k, j] = 10 * np.log10(np.sum(s_filt**2) / np.sum(e_interf**2))
            sar[k, j] = 10 * np.log10(
                np.sum((s_filt + e_interf) ** 2) / np.sum(e_artif**2)
            )
    return sdr, sir, sar


def test_matches_explicit_time_domain(rng):
    """The Gram quadratic-form energies equal materialized projections."""
    n, flen = 1500, 48
    refs = rng.laplace(size=(2, n))
    h = rng.standard_normal(8)
    ests = np.stack(
        [
            np.convolve(refs[0], h, "same") + 0.3 * refs[1] + 0.05 * rng.standard_normal(n),
            refs[1] + 0.2 * rng.standard_normal(n),
        ]
    )
    sdr_bf, sir_bf, sar_bf = _explicit_decomposition(refs, ests, flen)
    ev = BssEvalReferences(refs, filter_length=flen)
    sdr, sir, sar, perm = ev.evaluate(ests)
    np.testing.assert_array_equal(perm, [0, 1])
    idx = np.arange(2)
    np.testing.assert_allclose(sdr, sdr_bf[idx, idx], atol=1e-6)
    np.testing.assert_allclose(sir, sir_bf[idx, idx], atol=1e-6)
    np.testing.assert_allclose(sar, sar_bf[idx, idx], atol=1e-6)


def test_references_reuse_matches_oneshot(sources, rng):
    """One factorization scoring many estimate sets == per-call results."""
    ev = BssEvalReferences(sources)
    for trial in range(3):
        est = sources[[2, 0, 1]] + 0.1 * (trial + 1) * rng.standard_normal(
            sources.shape
        )
        a = ev.evaluate(est)
        b = bss_eval_sources(sources, est)
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=1e-12)


def test_images_variant(sources):
    imgs = np.stack([np.stack([s, 0.5 * s], axis=1) for s in sources])
    sdr, sir, sar, perm = bss_eval_images(imgs, imgs.copy())
    assert np.all(sdr > 100)
