"""Batched sweep harness: grouped same-shape instances through the fused
*_batch programs must reproduce the one-at-a-time sweep's JSONs exactly
, including resume-by-skip and padded partial chunks."""

import copy
import json
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "bench"))

from mbss_sim import DEFAULT_CONFIG, sweep  # noqa: E402


@pytest.fixture(scope="module")
def small_cfg():
    cfg = copy.deepcopy(DEFAULT_CONFIG)
    cfg.update(
        repeats=3, duration=1.5, nfft=256, n_mics=[2], n_srcs=[1, 2],
        seed=777,
    )
    cfg["algos"] = {
        "overiva": {"n_iter": 6},
        "ilrma": {"n_iter": 4, "n_components": 2},
        "five": {"n_iter": 4},
    }
    return cfg


def _records(out):
    return {
        f.name: json.loads(f.read_text()) for f in sorted(Path(out).glob("s*.json"))
    }


def test_batched_sweep_matches_serial(small_cfg, tmp_path):
    """3 seeds with cap 2 -> chunks [2, 1-padded-to-2] per cell; every
    quality field must equal the serial sweep's."""
    sweep(small_cfg, tmp_path / "serial", batch=1)
    sweep(small_cfg, tmp_path / "batched", batch=2)
    serial = _records(tmp_path / "serial")
    batched = _records(tmp_path / "batched")
    assert set(serial) == set(batched) and serial
    for name, rec in serial.items():
        brec = batched[name]
        assert set(rec["results"]) == set(brec["results"])
        for algo, res in rec["results"].items():
            bres = brec["results"][algo]
            assert "error" not in res and "error" not in bres, (algo, res, bres)
            for key in ("sdr", "sir", "sdr_improvement", "sir_improvement"):
                if key in res:
                    np.testing.assert_allclose(
                        res[key], bres[key], atol=2e-4,
                        err_msg=f"{name}/{algo}/{key}",
                    )


def test_batched_sweep_resumes(small_cfg, tmp_path):
    out = tmp_path / "resume"
    sweep(small_cfg, out, batch=2)
    files = sorted(out.glob("s*.json"))
    assert files
    victim = files[0]
    before = victim.read_text()
    victim.unlink()
    mtimes = {f.name: f.stat().st_mtime_ns for f in out.glob("s*.json")}
    sweep(small_cfg, out, batch=2)
    after = json.loads(victim.read_text())
    ref = json.loads(before)
    for algo, res in ref["results"].items():
        np.testing.assert_allclose(
            res["sdr"], after["results"][algo]["sdr"], atol=2e-4
        )
    # untouched instances were skipped, not recomputed
    for f in out.glob("s*.json"):
        if f.name != victim.name:
            assert f.stat().st_mtime_ns == mtimes[f.name]
