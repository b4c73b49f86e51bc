"""Room simulator validation (SURVEY.md §7.4 hard part #2): direct-path
delay, Schroeder decay vs target RT60, API shape checks."""

import numpy as np
import pytest

from overiva_jax.sim import (
    ShoeBox,
    circular_mic_array,
    inverse_sabine,
    semi_circle_layout,
    shoebox_rir,
    speech_like,
)


def schroeder_rt60(rir, fs):
    """RT60 from the -5..-25 dB slope of the Schroeder backward integral."""
    edc = np.cumsum(rir[::-1] ** 2)[::-1]
    edc_db = 10 * np.log10(np.maximum(edc / edc[0], 1e-12))
    t = np.arange(len(rir)) / fs
    m = (edc_db < -5) & (edc_db > -25)
    if m.sum() < 10:
        raise ValueError("decay range too short")
    p = np.polyfit(t[m], edc_db[m], 1)
    return -60.0 / p[0]


def test_direct_path_delay():
    fs = 16000
    dim = [6.0, 5.0, 3.0]
    src, mic = [2.0, 2.5, 1.5], [4.0, 2.5, 1.5]
    rir = shoebox_rir(dim, src, mic, fs, absorption=0.99, max_order=0)
    dist = 2.0
    expected = dist / 343.0 * fs + 40  # frac filter center offset
    peak = np.argmax(np.abs(rir))
    assert abs(peak - expected) < 2
    # amplitude ~ 1/(4 pi d)
    assert abs(rir[peak] - 1 / (4 * np.pi * dist)) < 0.01


def test_rt60_matches_sabine():
    fs = 16000
    dim = [6.0, 5.0, 3.2]
    rt60 = 0.25
    absorption, max_order = inverse_sabine(rt60, dim)
    rir = shoebox_rir(dim, [2.1, 3.0, 1.6], [4.4, 2.2, 1.4], fs, absorption, max_order)
    measured = schroeder_rt60(rir, fs)
    assert 0.6 * rt60 < measured < 1.6 * rt60, measured


def test_inverse_sabine_unreachable():
    with pytest.raises(ValueError):
        inverse_sabine(0.01, [10.0, 10.0, 4.0])


def test_shoebox_simulate_shapes():
    fs = 16000
    room = ShoeBox([6.0, 5.0, 3.0], fs=fs, rt60=0.2, seed=0)
    n = 8000
    room.add_source([2.0, 2.0, 1.5], speech_like(n, fs, seed=1))
    room.add_source([4.0, 3.5, 1.5], speech_like(n, fs, seed=2))
    room.add_mic_array(circular_mic_array([3.0, 2.5, 1.5], 0.05, 4))
    premix = room.simulate(return_premix=True)
    assert premix.shape[0] == 2 and premix.shape[1] == 4
    assert premix.shape[2] >= n
    mix = room.simulate(return_premix=False)
    np.testing.assert_allclose(mix, premix.sum(axis=0))
    assert np.all(np.isfinite(premix))


def test_positions_validated():
    with pytest.raises(ValueError):
        shoebox_rir([4, 4, 3], [5.0, 1.0, 1.0], [1, 1, 1], 16000, 0.3, 5)


def test_layout_shapes():
    pts = semi_circle_layout([3, 3, 1.5], np.pi, 2.0, 5)
    assert pts.shape == (5, 3)
    # equidistant from the arc center
    d = np.linalg.norm(pts[:, :2] - [3, 3], axis=1)
    np.testing.assert_allclose(d, 2.0, atol=1e-12)
    mics = circular_mic_array([3, 3, 1.5], 0.1, 8)
    assert mics.shape == (8, 3)
    d = np.linalg.norm(mics[:, :2] - [3, 3], axis=1)
    np.testing.assert_allclose(d, 0.1, atol=1e-12)


def test_random_and_grid_layouts():
    from overiva_jax.sim import grid_layout, random_layout

    rng = np.random.default_rng(0)
    pts = random_layout([0, 0, 0], [4, 5, 3], 10, rng=rng, margin=0.5)
    assert pts.shape == (10, 3)
    assert np.all(pts >= 0.5) and np.all(pts <= np.array([3.5, 4.5, 2.5]))

    g = grid_layout([1, 1, 0], [3, 3, 0], 6, z=1.2)
    assert g.shape == (6, 3)
    np.testing.assert_allclose(g[:, 2], 1.2)
    assert g[:, 0].min() >= 1 and g[:, 0].max() <= 3
