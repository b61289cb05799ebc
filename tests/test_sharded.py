"""Multi-device sharding tests on the 8-way virtual CPU mesh (SURVEY.md §4:
sharded vs single-device agreement without a multi-GPU host)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import oracle
from lbm_tpu.parallel.sharded import make_mesh, run_simulation_sharded
from lbm_tpu.runtime.driver import run_simulation


def test_virtual_mesh_has_8_devices():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("n_devices", [2, 4, 8])
def test_sharded_matches_single_device(n_devices, small_params, small_obstacles):
    # ny=16 divides by 2/4/8.
    single = run_simulation(
        small_params, small_obstacles, backend="reference", dtype=jnp.float64
    )
    sharded = run_simulation_sharded(
        small_params, small_obstacles, n_devices=n_devices, dtype=jnp.float64
    )
    np.testing.assert_allclose(sharded.cells, single.cells, rtol=1e-11)
    # Reduction order differs (psum of per-shard sums), so allow float slack.
    np.testing.assert_allclose(sharded.av_vels, single.av_vels, rtol=1e-10)


def test_sharded_matches_oracle(small_params, small_obstacles):
    sharded = run_simulation_sharded(
        small_params, small_obstacles, n_devices=4, dtype=jnp.float64
    )
    cells = oracle.initial_state(small_params)
    for _ in range(small_params.max_iters):
        cells, _ = oracle.step(
            cells,
            small_obstacles,
            small_params.density,
            small_params.accel,
            small_params.omega,
        )
    np.testing.assert_allclose(sharded.cells, cells, rtol=1e-9)


def test_sharded_accelerate_row_on_owner_shard(small_params, small_obstacles):
    """The forced row ny-2 sits inside the last shard; verify the forcing is
    applied exactly once (no duplication across shards)."""
    p = dataclasses.replace(small_params, max_iters=1)
    single = run_simulation(p, small_obstacles, backend="reference", dtype=jnp.float64)
    sharded = run_simulation_sharded(p, small_obstacles, n_devices=8, dtype=jnp.float64)
    np.testing.assert_allclose(sharded.cells, single.cells, rtol=1e-11)


def test_indivisible_grid_rejected(small_params, small_obstacles):
    p = dataclasses.replace(small_params, ny=18)
    obs = np.zeros((18, p.nx), dtype=np.int32)
    with pytest.raises(ValueError):
        run_simulation_sharded(p, obs, n_devices=4)


def test_make_mesh_too_many_devices():
    with pytest.raises(ValueError):
        make_mesh(1000)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 2), (2, 4), (1, 8)])
def test_sharded_2d_matches_single_device(mesh_shape, small_params, small_obstacles):
    """2-D (rows x cols) decomposition with two-phase halo exchange agrees
    with the single-device run, including diagonal (corner) streaming."""
    from lbm_tpu.parallel.sharded import run_simulation_sharded_2d

    single = run_simulation(
        small_params, small_obstacles, backend="reference", dtype=jnp.float64
    )
    sharded = run_simulation_sharded_2d(
        small_params, small_obstacles, mesh_shape=mesh_shape, dtype=jnp.float64
    )
    np.testing.assert_allclose(sharded.cells, single.cells, rtol=1e-11)
    np.testing.assert_allclose(sharded.av_vels, single.av_vels, rtol=1e-10)


def test_sharded_2d_indivisible_rejected(small_params, small_obstacles):
    from lbm_tpu.parallel.sharded import run_simulation_sharded_2d

    with pytest.raises(ValueError):
        run_simulation_sharded_2d(
            small_params, small_obstacles, mesh_shape=(2, 5)
        )


def test_sharded_checkpoint_resume(tmp_path, small_params, small_obstacles):
    """Checkpointed + resumed sharded run reproduces the uninterrupted one."""
    from lbm_tpu.runtime.checkpoint import load_checkpoint

    full = run_simulation_sharded(
        small_params, small_obstacles, n_devices=2, dtype=jnp.float64
    )
    path = tmp_path / "ck.npz"
    run_simulation_sharded(
        small_params, small_obstacles, n_devices=2, dtype=jnp.float64,
        checkpoint_every=7, checkpoint_path=str(path),
    )
    cells, av, step = load_checkpoint(path, small_params)
    assert step == small_params.max_iters
    np.testing.assert_allclose(cells, full.cells, rtol=1e-11)
    # Resume from a 7-step prefix.
    import dataclasses

    first7 = run_simulation_sharded(
        dataclasses.replace(small_params, max_iters=7),
        small_obstacles, n_devices=2, dtype=jnp.float64,
    )
    resumed = run_simulation_sharded(
        small_params, small_obstacles, n_devices=2, dtype=jnp.float64,
        initial_cells=first7.cells, start_step=7, av_vels_prefix=first7.av_vels,
    )
    np.testing.assert_allclose(resumed.av_vels, full.av_vels, rtol=1e-11)
    np.testing.assert_allclose(resumed.cells, full.cells, rtol=1e-11)


def test_sharded_bf16_av_series_is_f32(small_params, small_obstacles):
    """Under bf16 storage the av_vels series accumulates at f32, matching the
    single-device driver's policy."""
    res = run_simulation_sharded(
        small_params, small_obstacles, n_devices=4, backend="reference",
        dtype=jnp.bfloat16,
    )
    assert res.av_vels.dtype == np.float32
    assert res.cells.dtype == jnp.bfloat16


def _geometry(name, ny, nx):
    from lbm_tpu.utils.geometry import box

    if name == "box":
        return box(nx, ny)
    rng = np.random.RandomState(17)
    return (rng.rand(ny, nx) < 0.1).astype(np.int32)


# Tolerances against the single-device run of the same dtype: f32 differs
# only in the psum's order of summation; c16 may also flip one quantum.
_TOL = {"f32": dict(cells=1e-7, av=1e-5), "c16": dict(cells=5e-6, av=1e-3)}


def _check_against_single(sharded, single, dtype):
    tol = _TOL[dtype]
    assert sharded.cells.dtype == np.float32
    assert sharded.av_vels.dtype == np.float32
    np.testing.assert_allclose(sharded.cells, single.cells, atol=tol["cells"])
    np.testing.assert_allclose(sharded.av_vels, single.av_vels, rtol=tol["av"],
                               atol=1e-9)


@pytest.mark.parametrize("geometry", ["box", "random10"])
@pytest.mark.parametrize("dtype", ["f32", "c16"])
@pytest.mark.parametrize("n_devices", [2, 4, 8])
def test_sharded_1d_matrix(n_devices, dtype, geometry, small_params):
    """The jnp 1-D sharded step over 2/4/8 devices against one device."""
    obs = _geometry(geometry, small_params.ny, small_params.nx)
    dt = jnp.float32 if dtype == "f32" else "c16"
    single = run_simulation(small_params, obs, dtype=dt)
    sharded = run_simulation_sharded(small_params, obs, n_devices=n_devices,
                                     dtype=dt)
    _check_against_single(sharded, single, dtype)


@pytest.mark.parametrize("geometry", ["box", "random10"])
@pytest.mark.parametrize("dtype", ["f32", "c16"])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (2, 4), (4, 2), (1, 8)])
def test_sharded_2d_matrix(mesh_shape, dtype, geometry, small_params):
    """The jnp 2-D sharded step over four mesh shapes against one device."""
    from lbm_tpu.parallel.sharded import run_simulation_sharded_2d

    obs = _geometry(geometry, small_params.ny, small_params.nx)
    dt = jnp.float32 if dtype == "f32" else "c16"
    single = run_simulation(small_params, obs, dtype=dt)
    sharded = run_simulation_sharded_2d(small_params, obs,
                                        mesh_shape=mesh_shape, dtype=dt)
    _check_against_single(sharded, single, dtype)


@pytest.mark.parametrize("backend", ["pallas", "band2", "pallas-overlap"])
def test_sharded_rejects_removed_backends(backend, small_params, small_obstacles):
    """Backend names of the removed kernels error on both mesh ranks."""
    from lbm_tpu.parallel.sharded import run_simulation_sharded_2d

    with pytest.raises(ValueError, match="unknown backend"):
        run_simulation_sharded(small_params, small_obstacles, n_devices=2,
                               backend=backend)
    with pytest.raises(ValueError, match="unknown backend"):
        run_simulation_sharded_2d(small_params, small_obstacles,
                                  mesh_shape=(2, 2), backend=backend)
