"""HLO audit: every float32/complex64 contraction on the served path asks
for HIGHEST precision.

On a GPU, a float32 ``dot_general`` left at the platform default may run in
TF32 (about three decimal digits), which would silently move separation
quality away from the float64 oracle. This lowers the programs a user's
request runs — the fused ``Separator`` clip program and the streaming
online-ISS block step — and checks the precision of every contraction
whose operands are float32 or complex64.
"""

import re

import numpy as np
import pytest

import jax.numpy as jnp

from overiva_jax import serving

_DOT = re.compile(r"stablehlo\.dot_general\b.*")


def _low_precision_dots(hlo_text):
    """(n dots on f32/c64 operands, those not at HIGHEST on both)."""
    n, bad = 0, []
    for m in _DOT.finditer(hlo_text):
        line = m.group(0)
        assert " : (" in line and ") ->" in line, (
            f"unparsed dot_general: {line[:300]}"
        )
        operands = line.split(" : (", 1)[1].split(") ->", 1)[0]
        if "xf32>" not in operands and "complex<f32>" not in operands:
            continue
        n += 1
        if "precision = [HIGHEST, HIGHEST]" not in line:
            bad.append(line[:300])
    return n, bad


def _clip_hlo(algo):
    sep = serving.Separator(algo, n_src=2, nfft=256, n_iter=2)
    x = jnp.zeros((sep._prep_clip(np.zeros((4000, 3)))[4], 3), jnp.float32)
    return serving._serve_time_jit.lower(
        x, jnp.asarray(np.int32(3)), nfft=256, hop=128, n_src=2,
        rdt="float32", pcm_out=False, **sep._fused,
    ).as_text()


def _stream_hlo():
    sep = serving.StreamingSeparator("online-iss", n_chan=3, nfft=256,
                                     block_frames=4)
    x = jnp.zeros((sep.block_samples, 3), jnp.float32)
    return serving._stream_step_jit.lower(
        x, sep.tail, sep.carry, sep.state, sep.forget, sep.pb_forget,
        sep.tap_forget, **sep._static,
    ).as_text()


@pytest.mark.parametrize(
    "program",
    ["clip:overiva", "clip:overiva-iss", "stream:online-iss"],
)
def test_served_contractions_ask_for_highest(program):
    kind, algo = program.split(":")
    hlo = _clip_hlo(algo) if kind == "clip" else _stream_hlo()
    n, bad = _low_precision_dots(hlo)
    assert n > 0, "no float32/complex64 contraction found: audit is blind"
    assert not bad, f"{len(bad)}/{n} contractions below HIGHEST:\n" + "\n".join(bad)
