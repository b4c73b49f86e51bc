"""The package's former import name forwards to ``overiva_jax``.

The forwarding package is found as the repo's other top-level
``overiva_*`` package, so the test follows it without naming it. Each check
runs in a fresh interpreter: the forwarder edits ``sys.meta_path`` and the
environment at import time.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
ALIASES = sorted(
    p.parent.name for p in ROOT.glob("overiva_*/__init__.py")
    if p.parent.name != "overiva_jax"
)


def _run(code, **env):
    full = dict(os.environ, JAX_PLATFORMS="cpu", **env)
    return subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, timeout=120, cwd=ROOT, env=full,
    )


def test_one_former_name():
    assert len(ALIASES) == 1, ALIASES


@pytest.mark.parametrize("old", ALIASES)
def test_former_name_gives_same_modules(old):
    code = f"""
import warnings
with warnings.catch_warnings(record=True) as w:
    warnings.simplefilter("always")
    import {old}
    import {old}.serving
    from {old}.ops import linalg
    from {old} import overiva
assert any(issubclass(x.category, DeprecationWarning) for x in w), w
import overiva_jax, overiva_jax.serving, overiva_jax.ops.linalg
assert {old} is overiva_jax
assert {old}.serving is overiva_jax.serving
assert linalg is overiva_jax.ops.linalg
assert linalg.__spec__.name == "overiva_jax.ops.linalg", linalg.__spec__
assert overiva is overiva_jax.api.overiva
print("ok")
"""
    out = _run(code)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("old", ALIASES)
def test_former_native_switch_honoured(old):
    code = f"""
import os, warnings
warnings.simplefilter("ignore")
import {old}
print(os.environ.get("OVERIVA_JAX_NATIVE"))
"""
    env = {old.upper() + "_NATIVE": "0"}
    out = _run(code, **env)
    assert out.returncode == 0 and out.stdout.strip() == "0", out.stderr
    # the new switch, when set, wins
    out = _run(code, OVERIVA_JAX_NATIVE="1", **env)
    assert out.returncode == 0 and out.stdout.strip() == "1", out.stderr
