"""chip_smoke.py refuses to run anywhere but on a GPU with the package.

Its phases need the card and run there; what the CPU can check is that it
never falls back: without a GPU, or copied alone into a directory without
the package, it exits non-zero and prints no ``"ok": true`` line.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_without_gpu(where, tmp_path):
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if where == "alone":
        cwd = tmp_path
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, str(script)], capture_output=True, text=True,
        timeout=300, cwd=cwd, env=env,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert '"ok"' not in out.stdout
