"""Tests that need an NVIDIA GPU; they skip elsewhere. On a card:

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import oracle
from lbm_tpu.models.d2q9 import LBMParams
from lbm_tpu.runtime.driver import run_simulation
from lbm_tpu.utils.geometry import box_with_vertical_wall


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_compiled_step_on_gpu_matches_oracle(gpu, dtype):
    """The driver's loop, compiled for the GPU, against the NumPy oracle."""
    params = LBMParams(nx=64, ny=48, max_iters=30, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    obstacles = box_with_vertical_wall(params.nx, params.ny)
    result = run_simulation(params, obstacles, dtype=dtype, device=gpu)
    cells = oracle.initial_state(params)
    av = []
    for _ in range(params.max_iters):
        cells, tot_u = oracle.step(cells, obstacles, params.density,
                                   params.accel, params.omega)
        av.append(tot_u / int((obstacles == 0).sum()))
    rtol = 1e-4 if dtype == jnp.float32 else 1e-10
    np.testing.assert_allclose(result.av_vels, av, rtol=rtol)
    np.testing.assert_allclose(result.cells, cells, rtol=rtol)


@pytest.mark.gpu
def test_mesh_over_all_gpus_matches_one(gpu):
    """The 1-D sharded run over every GPU of the host against one GPU."""
    from lbm_tpu.parallel.sharded import run_simulation_sharded

    n = len(jax.devices())
    if n < 2:
        pytest.skip("needs two or more GPUs")
    params = LBMParams(nx=64, ny=16 * n, max_iters=20, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    obstacles = box_with_vertical_wall(params.nx, params.ny)
    single = run_simulation(params, obstacles, device=gpu)
    sharded = run_simulation_sharded(params, obstacles, n_devices=n)
    np.testing.assert_allclose(sharded.cells, single.cells, atol=1e-6)
    np.testing.assert_allclose(sharded.av_vels, single.av_vels, rtol=1e-5)
