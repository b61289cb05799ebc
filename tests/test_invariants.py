"""Physical and semantic invariants of the jnp step, per geometry family:
mass conservation, forcing confined to row ny-2 under the joint mask of
``ops/reference.py:44``, and bounce-back reversal on every obstacle cell."""

import jax.numpy as jnp
import numpy as np
import pytest

import oracle
from lbm_tpu.models.d2q9 import LBMParams
from lbm_tpu.ops.reference import accelerate_flow, collide, lbm_step_reference, stream
from test_step_oracle import GEOMETRIES, geometry, perturbed_state

SHAPES = [(16, 16), (24, 40), (48, 32)]  # (ny, nx)


def case(shape, geom):
    ny, nx = shape
    params = LBMParams(nx=nx, ny=ny, max_iters=20, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    return params, geometry(geom, ny, nx, seed=ny + nx)


@pytest.mark.parametrize("geom", GEOMETRIES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_mass_conserved(shape, geom):
    """Forcing moves mass between speeds, streaming and bounce-back permute
    it, collision conserves each cell's density: the total is unchanged."""
    params, obstacles = case(shape, geom)
    cells = jnp.asarray(perturbed_state(params, seed=3))
    obs = jnp.asarray(obstacles)
    total0 = float(jnp.sum(cells))
    for _ in range(params.max_iters):
        cells, _ = lbm_step_reference(cells, obs, params.density, params.accel,
                                      params.omega)
    assert float(jnp.sum(cells)) == pytest.approx(total0, rel=1e-12)


@pytest.mark.parametrize("geom", GEOMETRIES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_forcing_only_on_row_ny_minus_2_under_joint_mask(shape, geom):
    """accelerate_flow changes row ny-2 only, and there exactly the cells
    that are unblocked AND keep speeds 3, 6, 7 strictly positive after the
    update (kernels.cl:29-32), each by (+w1 on 1, +w2 on 5 and 8, -w1 on 3,
    -w2 on 6 and 7)."""
    params, obstacles = case(shape, geom)
    ny, nx = shape
    state = perturbed_state(params, seed=5)
    w1 = params.density * params.accel / 9.0
    w2 = params.density * params.accel / 36.0
    row = ny - 2
    # Push some columns below the positivity thresholds, one speed each.
    rng = np.random.RandomState(nx)
    for k, w in ((3, w1), (6, w2), (7, w2)):
        cols = rng.choice(nx, size=max(1, nx // 6), replace=False)
        state[k, row, cols] = w * rng.uniform(0.2, 1.0, cols.size)
    out = np.asarray(accelerate_flow(jnp.asarray(state), jnp.asarray(obstacles),
                                     params.density, params.accel))
    delta = out - state
    off_row = np.ones(ny, bool)
    off_row[row] = False
    assert np.all(delta[:, off_row, :] == 0.0)
    s = state[:, row, :]
    mask = (obstacles[row] == 0) & (s[3] - w1 > 0) & (s[6] - w2 > 0) & (s[7] - w2 > 0)
    pattern = np.array([0, w1, 0, -w1, 0, w2, -w2, -w2, w2])[:, None]
    np.testing.assert_allclose(delta[:, row, :], pattern * mask, rtol=0, atol=1e-15)
    assert np.all(delta[:, row, ~mask] == 0.0)


@pytest.mark.parametrize("geom", GEOMETRIES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_bounce_back_reverses_obstacle_cells(shape, geom):
    """After a full step, every obstacle cell holds the streamed-in
    populations reversed (speed k <- streamed opposite(k)), exactly; fluid
    cells are relaxed, not reversed."""
    params, obstacles = case(shape, geom)
    state = jnp.asarray(perturbed_state(params, seed=7))
    obs = jnp.asarray(obstacles)
    forced = accelerate_flow(state, obs, params.density, params.accel)
    streamed = np.asarray(stream(forced))
    new, _ = lbm_step_reference(state, obs, params.density, params.accel,
                                params.omega)
    new = np.asarray(new)
    blocked = obstacles != 0
    for k in range(9):
        np.testing.assert_array_equal(new[k][blocked], streamed[oracle.OPP[k]][blocked])
    relaxed, _ = collide(jnp.asarray(streamed), jnp.zeros_like(obs), params.omega)
    relaxed = np.asarray(relaxed)
    np.testing.assert_allclose(new[:, ~blocked], relaxed[:, ~blocked], rtol=1e-12)
