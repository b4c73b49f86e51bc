"""Native C++ RIR engine vs the NumPy reference path: same math, faster."""

import time

import numpy as np
import pytest

from overiva_jax.sim import shoebox_rir
from overiva_jax.sim._native import native_available

pytestmark = pytest.mark.skipif(
    not native_available(), reason="no C++ toolchain / native build failed"
)

DIM = [6.0, 5.0, 3.2]
SRC = [2.1, 3.0, 1.6]
MIC = [4.4, 2.2, 1.4]
FS = 16000


@pytest.mark.parametrize("max_order", [0, 3, 10])
def test_native_matches_numpy(max_order):
    r_np = shoebox_rir(DIM, SRC, MIC, FS, 0.3, max_order, use_native=False)
    r_cc = shoebox_rir(DIM, SRC, MIC, FS, 0.3, max_order, use_native=True)
    n = min(len(r_np), len(r_cc))
    np.testing.assert_allclose(r_cc[:n], r_np[:n], atol=1e-12)
    # anything beyond the common support is zero
    assert np.all(np.abs(r_cc[n:]) < 1e-12) or np.all(np.abs(r_np[n:]) < 1e-12)


def test_native_validates_geometry():
    with pytest.raises(ValueError):
        shoebox_rir(DIM, [9.0, 1.0, 1.0], MIC, FS, 0.3, 3, use_native=True)


def test_native_is_faster_at_high_order():
    t0 = time.perf_counter()
    shoebox_rir(DIM, SRC, MIC, FS, 0.2, 25, use_native=False)
    t_np = time.perf_counter() - t0
    t0 = time.perf_counter()
    shoebox_rir(DIM, SRC, MIC, FS, 0.2, 25, use_native=True)
    t_cc = time.perf_counter() - t0
    # don't gate hard on CI noise; native should not be slower
    assert t_cc < t_np * 1.5, (t_cc, t_np)
