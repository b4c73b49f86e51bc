"""Wav-directory source loader (the real-speech hook, SURVEY.md §2.1)."""

import numpy as np
import pytest
from scipy.io import wavfile

from overiva_jax.sim import load_wav_sources, speech_like


@pytest.fixture()
def wav_dir(tmp_path):
    """Three wavs covering the format matrix: int16 mono @16k, float32 mono
    @8k (needs resampling), int16 stereo @16k (needs mono-izing). One is
    short and must loop."""
    fs = 16000
    s0 = speech_like(fs * 2, fs, seed=1)
    wavfile.write(tmp_path / "a.wav", fs, (s0 * 0.3 * 32767).astype(np.int16))
    s1 = speech_like(8000 * 2, 8000, seed=2).astype(np.float32)
    wavfile.write(tmp_path / "b.wav", 8000, s1 * 0.5)
    s2 = speech_like(fs // 2, fs, seed=3)  # short: 0.5 s
    stereo = np.stack([s2, 0.8 * s2], axis=1)
    wavfile.write(tmp_path / "c.wav", fs, (stereo * 0.3 * 32767).astype(np.int16))
    return tmp_path


def test_loads_shape_and_variance(wav_dir):
    out = load_wav_sources(wav_dir, 3, 16000, fs=16000, seed=0)
    assert out.shape == (3, 16000)
    np.testing.assert_allclose(np.std(out, axis=1), 1.0, rtol=1e-6)
    assert np.isfinite(out).all()


def test_deterministic_per_seed(wav_dir):
    a = load_wav_sources(wav_dir, 2, 8000, seed=7)
    b = load_wav_sources(wav_dir, 2, 8000, seed=7)
    c = load_wav_sources(wav_dir, 2, 8000, seed=8)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_distinct_files_preferred(wav_dir):
    """With 3 files and 3 sources, each source comes from a different file."""
    out = load_wav_sources(wav_dir, 3, 4000, seed=3)
    for i in range(3):
        for j in range(i + 1, 3):
            c = abs(np.corrcoef(out[i], out[j])[0, 1])
            assert c < 0.9, (i, j, c)


def test_more_sources_than_files(wav_dir):
    out = load_wav_sources(wav_dir, 5, 4000, seed=4)
    assert out.shape == (5, 4000)


def test_empty_dir_raises(tmp_path):
    with pytest.raises(ValueError, match="no .wav files"):
        load_wav_sources(tmp_path, 2, 1000)


def test_sweep_config_hook(wav_dir, tmp_path, monkeypatch):
    """The sweep driver uses wav sources when the config names a directory."""
    import sys
    sys.path.insert(0, "bench")
    import mbss_sim

    cfg = {
        "fs": 8000, "duration": 1.0, "room_dim": [6.0, 5.0, 3.0],
        "source_dir": str(wav_dir),
    }
    mix, premix = mbss_sim.simulate_instance(cfg, 5, n_mics=2, n_src=2, rt60=0.2, snr=25)
    assert mix.shape[1] == 2 and premix.shape[0] == 2
    assert np.isfinite(mix).all()


def _find_speech_corpus():
    """Locate a real-speech corpus if one ever appears in this environment.

    Search order: $OVERIVA_SPEECH_DIR, then the conventional spots a CMU
    ARCTIC download would land in. Returns a directory containing >= 3
    wav files, or None.
    """
    import os
    from pathlib import Path

    candidates = [os.environ.get("OVERIVA_SPEECH_DIR")]
    candidates += [
        "/root/data/cmu_arctic",
        "/root/datasets/cmu_arctic",
        str(Path.home() / ".cache" / "overiva_jax" / "speech"),
        "/root/repo/data/speech",
    ]
    for c in candidates:
        if not c:
            continue
        p = Path(c)
        if p.is_dir() and len(list(p.rglob("*.wav"))) >= 3:
            return p
    return None


_CORPUS = _find_speech_corpus()


@pytest.mark.skipif(
    _CORPUS is None,
    reason="no real-speech corpus present (set OVERIVA_SPEECH_DIR or place "
    ">=3 wavs under data/speech/) — the --source-dir path is validated on "
    "generated wavs above; this test upgrades the validation to real "
    "recorded speech the moment data appears",
)
def test_real_speech_end_to_end():
    """Full oneshot pipeline on REAL recorded speech: separate a simulated
    3-mic/2-src room mixture built from corpus wavs and require a positive
    SIR improvement — the reference's CMU-ARCTIC demo scenario."""
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    proc = subprocess.run(
        [
            sys.executable, str(repo / "examples" / "oneshot.py"),
            "-a", "overiva", "-m", "3", "-s", "2",
            "--nfft", "1024", "--duration", "4",
            "--source-dir", str(_CORPUS), "--seed", "3",
        ],
        capture_output=True, text=True, timeout=1200,
        env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "SIR" in proc.stdout or "sir" in proc.stdout
