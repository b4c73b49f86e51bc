"""Covariance kernels: weighted, per-(t,f) weighted, frame-chunked streaming."""

import numpy as np

import jax.numpy as jnp

from overiva_jax.ops.covariance import (
    covariance,
    weighted_covariance,
    weighted_covariance_chunked,
    weighted_covariance_tf,
)


def _mk(rng, T=100, F=17, M=4):
    X = rng.standard_normal((T, F, M)) + 1j * rng.standard_normal((T, F, M))
    return jnp.asarray(X)


def test_covariance_hermitian_psd(rng):
    X = _mk(rng)
    C = np.asarray(covariance(X))
    np.testing.assert_allclose(C, np.conj(np.swapaxes(C, 1, 2)), atol=1e-12)
    eig = np.linalg.eigvalsh(C)
    assert eig.min() > -1e-10


def test_weighted_covariance_matches_einsum(rng):
    X = _mk(rng)
    phi = jnp.asarray(rng.random(100))
    V = np.asarray(weighted_covariance(X, phi))
    Vref = np.einsum("t,tfm,tfn->fmn", np.asarray(phi), np.asarray(X), np.conj(np.asarray(X))) / 100
    np.testing.assert_allclose(V, Vref, atol=1e-10)


def test_chunked_matches_dense(rng):
    """Streaming accumulation (SURVEY §5.7) == dense, including the padded
    tail when T is not a multiple of the chunk."""
    X = _mk(rng, T=100)
    phi = jnp.asarray(rng.random(100))
    V_dense = np.asarray(weighted_covariance(X, phi))
    for chunk in (25, 32, 100, 256):
        V_chunk = np.asarray(weighted_covariance_chunked(X, phi, chunk=chunk))
        np.testing.assert_allclose(V_chunk, V_dense, atol=1e-10, err_msg=str(chunk))


def test_weighted_tf_matches_einsum(rng):
    X = _mk(rng)
    w = jnp.asarray(rng.random((100, 17)))
    V = np.asarray(weighted_covariance_tf(X, w))
    Vref = np.einsum("tf,tfm,tfn->fmn", np.asarray(w), np.asarray(X), np.conj(np.asarray(X))) / 100
    np.testing.assert_allclose(V, Vref, atol=1e-10)


def test_chunked_bf16_close_to_dense(rng):
    """wcov="bf16" threads through the streamed path:
    per-chunk bfloat16 operands, f32 accumulation — relative error at the
    bf16 operand-rounding scale, not silently the f32 path."""
    X = _mk(rng, T=96).astype(jnp.complex64)
    phi = jnp.asarray(rng.random(96), jnp.float32)
    V_dense = np.asarray(weighted_covariance(X, phi))
    V16 = np.asarray(weighted_covariance_chunked(X, phi, chunk=32, wcov="bf16"))
    scale = np.abs(V_dense).max()
    err = np.abs(V16 - V_dense).max() / scale
    assert 1e-8 < err < 5e-2, err  # bf16-rounded, but not the exact f32 path


def test_weighted_all_chunked_matches_dense(rng):
    """All-K frame-chunked scan (the bounded-memory form) == dense,
    including a padded tail."""
    from overiva_jax.ops.covariance import weighted_covariance_all

    X = _mk(rng, T=100)
    phi = jnp.asarray(rng.random((100, 3)))
    V_dense = np.asarray(weighted_covariance_all(X, phi))
    for chunk in (32, 50, 100, 256):
        V_c = np.asarray(weighted_covariance_all(X, phi, chunk=chunk))
        np.testing.assert_allclose(V_c, V_dense, atol=1e-10, err_msg=str(chunk))


def test_wcov_f32x3_mode_runs_and_matches_on_cpu(rng):
    """f32x3 (lax.Precision.HIGH): exact on CPU (precision flags do not
    change the CPU lowering); on the GPU it runs as TF32."""
    from overiva_jax.ops.covariance import (
        weighted_covariance_all,
        weighted_covariance_tf,
    )

    X = _mk(rng).astype(jnp.complex64)
    phi = jnp.asarray(rng.random((100, 2)), jnp.float32)
    V = np.asarray(weighted_covariance_all(X, phi, "f32x3"))
    Vref = np.asarray(weighted_covariance_all(X, phi, "f32"))
    np.testing.assert_allclose(V, Vref, rtol=2e-5)
    w = jnp.asarray(rng.random((100, 17)), jnp.float32)
    V2 = np.asarray(weighted_covariance_tf(X, w, "f32x3"))
    V2ref = np.asarray(weighted_covariance_tf(X, w, "f32"))
    np.testing.assert_allclose(V2, V2ref, rtol=2e-5)
