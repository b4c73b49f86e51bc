"""Multi-device (fake 8-device CPU mesh) sharding tests (SURVEY.md §4):
bin-sharded + mixture-sharded execution must match the single-device path."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from overiva_jax import api
from overiva_jax.parallel.mesh import make_mesh
from overiva_jax.parallel.sharded import (
    sharded_auxiva_iss,
    sharded_auxiva_pca,
    sharded_ogive,
    sharded_overiva,
)

from helpers import make_mixture, stft_mixture


@pytest.fixture(scope="module")
def batch():
    rngs = [np.random.default_rng(s) for s in (5, 6)]
    Xs = []
    for rng in rngs:
        mix, _, _ = make_mixture(rng, n_src=2, n_mics=4, n_samples=12000, snr_db=20)
        Xs.append(stft_mixture(mix, nfft=256))
    return np.stack(Xs)  # (2, T, 129, 4)


def _run_sharded(batch_np, mesh, n_iter=5):
    Xd = jnp.asarray(batch_np)  # CPU: complex transfer is fine
    Y = sharded_overiva(mesh, Xd, n_src=2, n_iter=n_iter)
    return np.asarray(Y)


@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4), (2, 1)])
def test_sharded_matches_single_device(batch, mesh_shape):
    assert len(jax.devices()) >= mesh_shape[0] * mesh_shape[1]
    mesh = make_mesh(*mesh_shape, devices=jax.devices()[: mesh_shape[0] * mesh_shape[1]])
    Ys = _run_sharded(batch, mesh)
    for b in range(batch.shape[0]):
        Yref = api.overiva(batch[b], n_src=2, n_iter=5, dtype=np.complex128)
        np.testing.assert_allclose(Ys[b], Yref, rtol=1e-6, atol=1e-8)


def test_bin_padding_roundtrip(batch):
    """129 bins over 8 shards needs padding to 136; output must be sliced
    back and identical in the real bins."""
    mesh = make_mesh(1, 8)
    Y = _run_sharded(batch, mesh)
    assert Y.shape == (2, batch.shape[1], 129, 2)
    assert np.all(np.isfinite(Y))


def test_mix_axis_requires_divisible_batch(batch):
    mesh = make_mesh(8, 1)
    with pytest.raises(ValueError):
        _run_sharded(batch, mesh)  # B=2 not divisible by 8


@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4)])
def test_sharded_auxiva_pca_matches_single_device(batch, mesh_shape):
    # the 15th family: per-bin eigh reduction is
    # bin-local, the inner determined AuxIVA psums activations as usual
    assert len(jax.devices()) >= mesh_shape[0] * mesh_shape[1]
    mesh = make_mesh(
        *mesh_shape, devices=jax.devices()[: mesh_shape[0] * mesh_shape[1]]
    )
    Y = np.asarray(sharded_auxiva_pca(mesh, jnp.asarray(batch), n_src=2,
                                      n_iter=5))
    for b in range(batch.shape[0]):
        Yref = api.auxiva_pca(batch[b], n_src=2, n_iter=5,
                              dtype=np.complex128)
        np.testing.assert_allclose(Y[b], Yref, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4)])
def test_sharded_iss_matches_single_device(batch, mesh_shape):
    from overiva_jax import api

    mesh = make_mesh(*mesh_shape, devices=jax.devices()[: mesh_shape[0] * mesh_shape[1]])
    Y = np.asarray(sharded_auxiva_iss(mesh, jnp.asarray(batch), n_iter=6))
    for b in range(batch.shape[0]):
        Yref = api.auxiva_iss(batch[b], n_iter=6, dtype=np.complex128)
        np.testing.assert_allclose(Y[b], Yref, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4)])
def test_sharded_ilrma_matches_single_device(batch, mesh_shape):
    from overiva_jax import api
    from overiva_jax.parallel.sharded import sharded_ilrma

    mesh = make_mesh(*mesh_shape, devices=jax.devices()[: mesh_shape[0] * mesh_shape[1]])
    Y = np.asarray(sharded_ilrma(mesh, jnp.asarray(batch), n_iter=5, seed=7))
    for b in range(batch.shape[0]):
        Yref = api.ilrma(batch[b], n_iter=5, seed=7 + b, dtype=np.complex128)
        np.testing.assert_allclose(Y[b], Yref, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 2)])
def test_sharded_ogive_matches_single_device(batch, mesh_shape):
    from overiva_jax import api

    mesh = make_mesh(*mesh_shape, devices=jax.devices()[: mesh_shape[0] * mesh_shape[1]])
    Xd = jnp.asarray(batch)
    Y = np.asarray(
        sharded_ogive(mesh, Xd, n_iter=40, step_size=0.05, tol=1e-4)
    )
    for b in range(batch.shape[0]):
        Yref = api.ogive(
            batch[b], n_iter=40, step_size=0.05, tol=1e-4, dtype=np.complex128
        )
        np.testing.assert_allclose(Y[b], Yref, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4)])
def test_sharded_fastmnmf2_matches_single_device(batch, mesh_shape):
    from overiva_jax import api
    from overiva_jax.parallel.sharded import sharded_fastmnmf2

    mesh = make_mesh(*mesh_shape, devices=jax.devices()[: mesh_shape[0] * mesh_shape[1]])
    Y = np.asarray(
        sharded_fastmnmf2(mesh, jnp.asarray(batch), n_src=2, n_iter=5, seed=7)
    )
    for b in range(batch.shape[0]):
        Yref = api.fastmnmf2(
            batch[b], n_src=2, n_iter=5, seed=7 + b, dtype=np.complex128
        )
        np.testing.assert_allclose(Y[b], Yref, rtol=1e-5, atol=1e-7)


def test_sharded_fastmnmf1_matches_single_device(batch):
    """Untied per-frequency g (FastMNMF1): g is bin-sharded and its update
    is local — the sharded trajectory must still equal single-device."""
    from overiva_jax import api
    from overiva_jax.parallel.sharded import sharded_fastmnmf2

    mesh = make_mesh(2, 4, devices=jax.devices()[:8])
    Y = np.asarray(
        sharded_fastmnmf2(
            mesh, jnp.asarray(batch), n_src=2, n_iter=5, seed=7, tie_g=False
        )
    )
    for b in range(batch.shape[0]):
        Yref = api.fastmnmf(
            batch[b], n_src=2, n_iter=5, seed=7 + b, dtype=np.complex128
        )
        np.testing.assert_allclose(Y[b], Yref, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4)])
def test_sharded_five_matches_single_device(batch, mesh_shape):
    from overiva_jax import api
    from overiva_jax.parallel.sharded import sharded_five

    mesh = make_mesh(*mesh_shape, devices=jax.devices()[: mesh_shape[0] * mesh_shape[1]])
    Y = np.asarray(sharded_five(mesh, jnp.asarray(batch), n_iter=6))
    for b in range(batch.shape[0]):
        Yref = api.five(batch[b], n_iter=6, dtype=np.complex128)
        np.testing.assert_allclose(Y[b], Yref, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4)])
def test_sharded_sparseauxiva_matches_single_device(batch, mesh_shape):
    """Subset-IP sharded over the selected-bin axis, FISTA replicated after
    the k-bin gather, polish on the full-bin axis — must equal the
    single-device api.sparseauxiva trajectory."""
    from overiva_jax import api
    from overiva_jax.parallel.sharded import sharded_sparseauxiva

    mesh = make_mesh(*mesh_shape, devices=jax.devices()[: mesh_shape[0] * mesh_shape[1]])
    Y = np.asarray(
        sharded_sparseauxiva(
            mesh, jnp.asarray(batch), n_iter=5, lasso_iter=40, polish_iter=2
        )
    )
    for b in range(batch.shape[0]):
        Yref = api.sparseauxiva(
            batch[b], n_iter=5, lasso_iter=40, polish_iter=2,
            dtype=np.complex128,
        )
        np.testing.assert_allclose(Y[b], Yref, rtol=1e-6, atol=1e-8)


def test_sharded_sparseauxiva_explicit_s_and_validation(batch):
    from overiva_jax.parallel.sharded import sharded_sparseauxiva

    mesh = make_mesh(2, 4)
    F = batch.shape[2]
    with pytest.raises(ValueError, match="all bins"):
        sharded_sparseauxiva(mesh, jnp.asarray(batch), S=np.arange(F))
    with pytest.raises(ValueError, match="increasing"):
        sharded_sparseauxiva(mesh, jnp.asarray(batch), S=np.array([5, 3, 9]))
    Y = np.asarray(
        sharded_sparseauxiva(
            mesh, jnp.asarray(batch), S=np.arange(0, F, 4), n_iter=3,
            lasso_iter=20, polish_iter=1,
        )
    )
    assert Y.shape == batch.shape and np.isfinite(Y).all()


@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4)])
def test_sharded_wpe_matches_single_device(batch, mesh_shape):
    from overiva_jax.parallel.sharded import sharded_wpe

    assert len(jax.devices()) >= mesh_shape[0] * mesh_shape[1]
    mesh = make_mesh(*mesh_shape, devices=jax.devices()[: mesh_shape[0] * mesh_shape[1]])
    Y = np.asarray(sharded_wpe(mesh, jnp.asarray(batch), taps=3, delay=1, n_iter=2))
    assert Y.shape == batch.shape
    for b in range(batch.shape[0]):
        Yref = api.wpe(batch[b], taps=3, delay=1, n_iter=2,
                       dtype=np.complex128)
        np.testing.assert_allclose(Y[b], Yref, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4)])
def test_sharded_online_iss_matches_oracle(batch, mesh_shape):
    """Streaming twin: B parallel streams, mix-axis
    data parallel AND bin-sharded, block-scanned state — must match the
    float64 NumPy oracle stream (oracle/online_iss.py) per element."""
    from overiva_jax.oracle.online_iss import online_iss_run
    from overiva_jax.parallel.sharded import sharded_online_iss

    assert len(jax.devices()) >= mesh_shape[0] * mesh_shape[1]
    mesh = make_mesh(
        *mesh_shape, devices=jax.devices()[: mesh_shape[0] * mesh_shape[1]]
    )
    block = 16
    T = (batch.shape[1] // block) * block
    Xb = batch[:, :T]
    Y = np.asarray(
        sharded_online_iss(
            mesh, jnp.asarray(Xb), block=block, forget=0.97, n_pass=2
        )
    )
    for b in range(Xb.shape[0]):
        Yref = online_iss_run(Xb[b], block, forget=0.97, n_pass=2)
        np.testing.assert_allclose(Y[b], Yref, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4)])
def test_sharded_online_tiss_matches_single_device(batch, mesh_shape):
    """Streaming JOINT dereverb+separation twin: must match the
    single-device online_tiss_step stream per element (c128) — the tap
    normal-equation solve is per-bin, so sharding only reorders the one
    power psum."""
    from overiva_jax.models.online_tiss import (
        online_tiss_init,
        online_tiss_step,
    )
    from overiva_jax.parallel.sharded import sharded_online_tiss

    assert len(jax.devices()) >= mesh_shape[0] * mesh_shape[1]
    mesh = make_mesh(
        *mesh_shape, devices=jax.devices()[: mesh_shape[0] * mesh_shape[1]]
    )
    block, taps, delay = 16, 2, 1
    T = (batch.shape[1] // block) * block
    Xb = batch[:, :T]
    forget = jnp.asarray(0.97, jnp.float64)
    Y = np.asarray(
        sharded_online_tiss(
            mesh, jnp.asarray(Xb), block=block, taps=taps, delay=delay,
            forget=0.97, n_pass=2,
        )
    )
    for b in range(Xb.shape[0]):
        F, M = Xb.shape[2], Xb.shape[3]
        state = online_tiss_init(F, M, taps, delay, "solve", jnp.complex128)
        outs = []
        for t0 in range(0, T, block):
            Yblk, state = online_tiss_step(
                jnp.asarray(Xb[b, t0 : t0 + block]), state, forget,
                taps=taps, delay=delay, n_pass=2,
            )
            outs.append(np.asarray(Yblk))
        Yref = np.concatenate(outs, axis=0)
        np.testing.assert_allclose(Y[b], Yref, rtol=1e-6, atol=1e-8)
