"""The jnp step, through the driver, against the float64 NumPy oracle over a
matrix of grid shapes x geometries x precisions x step counts.

Geometries are the reference decks' families (``utils/geometry.py``) plus
seeded random masks at 10% and 40% blocked. Each run starts from a seeded
perturbation of the at-rest state, so every population moves from step 1.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import oracle
from lbm_tpu.models.d2q9 import LBMParams
from lbm_tpu.runtime.driver import run_simulation
from lbm_tpu.utils.geometry import box, box_with_vertical_wall, channel_with_divider

SHAPES = [(8, 8), (16, 24), (32, 32), (20, 36), (64, 16)]  # (ny, nx)
GEOMETRIES = ["box", "channel", "wall", "random10", "random40"]


def geometry(name, ny, nx, seed=0):
    if name == "box":
        return box(nx, ny)
    if name == "channel":
        return channel_with_divider(nx, ny)
    if name == "wall":
        return box_with_vertical_wall(nx, ny)
    frac = {"random10": 0.1, "random40": 0.4}[name]
    mask = (np.random.RandomState(seed).rand(ny, nx) < frac).astype(np.int32)
    mask[ny - 2, 0] = 0  # keep at least one free cell on the forced row
    return mask


def perturbed_state(params, seed=0):
    rng = np.random.RandomState(seed)
    base = oracle.initial_state(params)
    return base * (1.0 + 0.1 * rng.rand(*base.shape))


def oracle_run(params, obstacles, cells):
    tot_cells = int((obstacles == 0).sum())
    av = []
    for _ in range(params.max_iters):
        cells, tot_u = oracle.step(cells, obstacles, params.density,
                                   params.accel, params.omega)
        av.append(tot_u / tot_cells)
    return cells, np.array(av)


# f64 must match the oracle to rounding; f32 to its own precision.
TOL = {"f64": dict(cells=1e-9, av=1e-9), "f32": dict(cells=2e-6, av=2e-4)}


@pytest.mark.parametrize("steps", [1, 13])
@pytest.mark.parametrize("precision", ["f32", "f64"])
@pytest.mark.parametrize("geom", GEOMETRIES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_step_matches_oracle(shape, geom, precision, steps):
    ny, nx = shape
    params = LBMParams(nx=nx, ny=ny, max_iters=steps, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    obstacles = geometry(geom, ny, nx)
    start = perturbed_state(params, seed=ny * nx + steps)
    dtype = jnp.float32 if precision == "f32" else jnp.float64
    result = run_simulation(params, obstacles, dtype=dtype,
                            initial_cells=start.astype(dtype))
    want_cells, want_av = oracle_run(params, obstacles,
                                     start.astype(dtype).astype(np.float64))
    tol = TOL[precision]
    np.testing.assert_allclose(result.cells, want_cells, rtol=tol["cells"],
                               atol=tol["cells"] * 0.1)
    np.testing.assert_allclose(result.av_vels, want_av, rtol=tol["av"])
