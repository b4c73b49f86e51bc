"""Demo-CLI smoke test: the user-facing arg surface keeps working (CPU)."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def test_oneshot_cli_runs(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [
            sys.executable, str(REPO / "examples" / "oneshot.py"),
            "-a", "auxiva-iss", "-m", "2", "-s", "2",
            "--nfft", "128", "--duration", "1.0", "--n_iter", "5",
            "--save", str(tmp_path / "wavs"),
        ],
        capture_output=True,
        text=True,
        timeout=600,  # compiles in the subprocess are slow under suite load
        cwd=REPO,
        env=env,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "SDR" in out.stdout
    assert (tmp_path / "wavs" / "sep_0.wav").exists()


def test_oneshot_cli_rejects_unknown_algo():
    out = subprocess.run(
        [sys.executable, str(REPO / "examples" / "oneshot.py"), "-a", "fastica"],
        capture_output=True,
        text=True,
        timeout=60,
        cwd=REPO,
    )
    assert out.returncode != 0


def test_streaming_cli_fused_runs():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [
            sys.executable, str(REPO / "examples" / "streaming.py"),
            "--mics", "2", "--duration", "2.0", "--nfft", "256",
            "--block", "8", "--fused",
        ],
        capture_output=True,
        text=True,
        timeout=600,
        cwd=REPO,
        env=env,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "fused stream" in out.stdout and "per-block" in out.stdout
