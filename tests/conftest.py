"""Test configuration: force JAX onto CPU with 8 virtual devices.

Tests never require an accelerator (SURVEY.md §4): numerical/parity tests
run on CPU with x64 available, and sharding tests use a fake 8-device host
mesh via ``--xla_force_host_platform_device_count=8``. Must run before jax
imports. What needs the card is checked by ``chip_smoke.py``.
"""

import os

# Force (not setdefault): a GPU machine would otherwise pick its card.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_ENABLE_X64"] = "1"

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# surface NaNs produced inside jitted programs at the op that made them
# (SURVEY.md §5.2) — the algorithms guard all divisions, so any NaN is a bug
jax.config.update("jax_debug_nans", True)

import numpy as np
import pytest

# NO persistent compilation cache here, deliberately. Three suite runs
# segfaulted deterministically in jax's
# compilation_cache.get_executable_and_time when the CPU test backend
# read .jax_cache entries written by the accelerator entry points
# (bench/mbss_sim.py used to enable the shared cache at import time,
# re-pointing the whole suite at it mid-run — fixed to enable in main()
# only). The double-float programs therefore recompile each suite run
# (~60-90 s per shape); correctness beats wall-clock. If a test-only
# cache dir is ever re-attempted, verify a FULL back-to-back double
# suite run first.


@pytest.fixture
def rng():
    return np.random.default_rng(12345)
