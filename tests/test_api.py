"""High-level Simulation API tests."""

import numpy as np
import pytest

from lbm_tpu.api import Simulation
from lbm_tpu.utils.geometry import box


def test_simulation_roundtrip(small_params, small_obstacles, tmp_path):
    sim = Simulation(small_params, small_obstacles)
    result = sim.run(backend="reference")
    assert result.av_vels.shape == (small_params.max_iters,)
    re = sim.reynolds(result)
    assert np.isfinite(re) and re > 0
    u_x, u_y, speed, pressure = sim.velocity_field(result)
    assert speed.shape == (small_params.ny, small_params.nx)
    sim.write_outputs(result, out_dir=tmp_path)
    assert (tmp_path / "final_state.dat").exists()
    assert (tmp_path / "av_vels.dat").exists()


def test_simulation_from_files(tmp_path):
    from lbm_tpu.utils.decks import write_deck

    sim = Simulation.from_files(*write_deck("128x128", tmp_path))
    assert sim.params.nx == 128 and sim.obstacles.sum() == 4 * 128 - 4


def test_simulation_mesh_variants(small_params, small_obstacles):
    sim = Simulation(small_params, small_obstacles)
    single = sim.run(backend="reference")
    mesh1d = sim.run(backend="reference", mesh=2)
    mesh2d = sim.run(mesh=(2, 2))
    np.testing.assert_allclose(mesh1d.av_vels, single.av_vels, rtol=1e-5)
    np.testing.assert_allclose(mesh2d.av_vels, single.av_vels, rtol=1e-5)
    # c16 storage works on every mesh shape (2-D added in round 3).
    mesh2d_c16 = sim.run(mesh=(2, 2), dtype="c16")
    np.testing.assert_allclose(mesh2d_c16.av_vels, single.av_vels, rtol=2e-3,
                               atol=1e-9)


def test_simulation_shape_mismatch(small_params):
    with pytest.raises(ValueError):
        Simulation(small_params, box(8, 8))


def test_simulation_2d_mesh_threads_backend(small_params, small_obstacles, monkeypatch):
    """The 2-D-mesh branch must pass ``backend`` through (it was once
    silently dropped)."""
    import lbm_tpu.parallel.sharded as sharded_mod

    seen = {}
    real = sharded_mod.run_simulation_sharded_2d

    def spy(params, obstacles, *, mesh_shape, backend="auto", dtype=None):
        seen["backend"] = backend
        return real(
            params, obstacles, mesh_shape=mesh_shape, backend=backend,
            dtype=dtype,
        )

    monkeypatch.setattr(sharded_mod, "run_simulation_sharded_2d", spy)
    sim = Simulation(small_params, small_obstacles)
    result = sim.run(mesh=(2, 2), backend="reference")
    assert seen["backend"] == "reference"
    assert result.av_vels.shape == (small_params.max_iters,)


def test_simulation_2d_mesh_checkpoint_kwargs(small_params, small_obstacles,
                                              tmp_path):
    """Checkpoint kwargs thread through to the 2-D-mesh runner (round-3
    parity); unknown kwargs still fail loudly instead of being dropped."""
    sim = Simulation(small_params, small_obstacles)
    ckpt = str(tmp_path / "api2d.npz")
    result = sim.run(mesh=(2, 2), checkpoint_every=3,
                     checkpoint_path=ckpt)
    assert result.av_vels.shape == (small_params.max_iters,)
    import numpy as np

    assert int(np.load(ckpt)["step"]) == small_params.max_iters
    with pytest.raises(TypeError):
        sim.run(mesh=(2, 2), not_a_kwarg=1)
