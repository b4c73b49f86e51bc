"""bf16 weighted-covariance mode (wcov="bf16", docs/DESIGN.md §2c).

The bfloat16 contraction rounds the V operands to ~3 decimal digits;
these tests pin (a) the elementwise agreement of the two wcov paths and
(b) that separation quality through the full IP iteration is unaffected
at the dB level.
"""

import numpy as np
import pytest

from overiva_jax import api
from overiva_jax.metrics import BssEvalReferences
from overiva_jax.oracle import synthesis

from helpers import make_mixture, stft_mixture


def test_wcov_bf16_matches_f32():
    import jax
    import jax.numpy as jnp

    from overiva_jax.ops.covariance import weighted_covariance_all

    rng = np.random.default_rng(0)
    T, F, M, K = 32, 17, 4, 2
    X = jnp.asarray(
        rng.standard_normal((T, F, M)) + 1j * rng.standard_normal((T, F, M)),
        dtype=jnp.complex64,
    )
    phi = jnp.asarray(np.abs(rng.standard_normal((T, K))), dtype=jnp.float32)
    V32 = np.asarray(jax.jit(weighted_covariance_all)(X, phi))
    V16 = np.asarray(
        jax.jit(lambda x, p: weighted_covariance_all(x, p, "bf16"))(X, phi)
    )
    scale = np.abs(V32).max()
    assert np.abs(V16 - V32).max() / scale < 2e-2
    # Hermitian up to bf16 operand rounding (the phi weight is folded into
    # one operand, so (m,n) and (n,m) round differently at ~1e-3)
    np.testing.assert_allclose(
        V16, np.conj(np.swapaxes(V16, -1, -2)), atol=5e-3 * scale
    )


@pytest.mark.parametrize(
    "algo", ["overiva", "overiva_ip2", "ilrma", "fastmnmf2"]
)
def test_bf16_quality_parity(algo, rng):
    """Full-pipeline SIR in bf16-wcov mode within 0.3 dB of the f32 path."""
    mix, premix, _ = make_mixture(
        rng, n_src=2, n_mics=4, n_samples=24000, n_taps=8, snr_db=25
    )
    nfft, hop = 512, 256
    X = stft_mixture(mix, nfft)
    ev = BssEvalReferences(premix[:, :, 0])
    fn = getattr(api, algo)
    kw = {"n_iter": 15}
    if algo == "ilrma":
        X = X[:, :, :2]  # determined
    else:
        kw["n_src"] = 2
    if algo == "fastmnmf2":
        kw["n_iter"] = 40  # MU updates converge slower than IP
    sirs = {}
    for mode in ("f32", "bf16"):
        Y = fn(X, wcov=mode, **kw)
        y = synthesis(Y, nfft, hop)[nfft - hop :][: mix.shape[0]]
        _, sir, _, _ = ev.evaluate(y.T)
        sirs[mode] = sir.mean()
    assert sirs["f32"] > 6.0, f"f32 baseline failed to separate: {sirs}"
    assert abs(sirs["bf16"] - sirs["f32"]) < 0.3, sirs


def test_wcov_validation():
    X = np.zeros((8, 5, 2), dtype=np.complex64)
    with pytest.raises(ValueError):
        api.overiva(X, n_src=2, wcov="f16")
    with pytest.raises(ValueError):
        api.overiva_ip2(X, n_src=2, wcov="fast")


_UNKNOWN_TIER_ENTRY_POINTS = {
    "overiva": lambda X: api.overiva(X, n_src=2, wcov="bf16pack"),
    "overiva_chunked": lambda X: api.overiva(
        X, n_src=2, wcov="bf16pack", chunk_frames=16
    ),
    "ilrma": lambda X: api.ilrma(X, n_iter=2, wcov="bf16pack"),
    "fastmnmf2": lambda X: api.fastmnmf2(
        X, n_src=2, n_iter=2, wcov="bf16pack"
    ),
    "tip": lambda X: api.tip(
        X, n_src=2, taps=2, delay=1, n_iter=2, wcov="bf16pack"
    ),
    "tip_batch": lambda X: api.tip_batch(
        X[None], n_src=2, taps=2, delay=1, n_iter=2, wcov="bf16pack"
    ),
    "separator_tip": lambda X: __import__(
        "overiva_jax.serving", fromlist=["Separator"]
    ).Separator("tip", n_src=2, nfft=256, wcov="bf16pack"),
}


@pytest.mark.parametrize("entry", sorted(_UNKNOWN_TIER_ENTRY_POINTS))
def test_removed_bf16pack_tier_rejected(entry, rng):
    """The packed-bf16 tier was removed; every entry point that takes
    ``wcov`` refuses the old name as an unknown tier instead of silently
    running another tier under its label."""
    mix, _, _ = make_mixture(rng, n_src=2, n_mics=2, n_samples=8000)
    X = stft_mixture(mix, 256)
    with pytest.raises(ValueError, match="wcov must be one of"):
        _UNKNOWN_TIER_ENTRY_POINTS[entry](X)
