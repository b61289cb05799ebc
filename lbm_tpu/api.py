"""High-level Python API.

The CLI mirrors the reference's surface; this module is the library-first
entry point::

    from lbm_tpu.api import Simulation

    sim = Simulation.from_files("input_128x128.params", "obstacles_128x128.dat")
    result = sim.run()                     # full maxIters on device
    result.av_vels, result.cells           # the av_vels series, final state
    sim.reynolds(result)                   # physics diagnostic
    sim.write_outputs(result, out_dir=".") # reference-format .dat files

or fully programmatic::

    from lbm_tpu.api import Simulation
    from lbm_tpu.models.d2q9 import LBMParams
    from lbm_tpu.utils.geometry import box

    params = LBMParams(nx=256, ny=256, max_iters=1000, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    sim = Simulation(params, box(256, 256))
    result = sim.run(dtype="c16")
"""

from __future__ import annotations

import os

import numpy as np

from lbm_tpu.models.d2q9 import LBMParams
from lbm_tpu.runtime.compile_cache import enable_compile_cache
from lbm_tpu.runtime.driver import SimulationResult, run_simulation


class Simulation:
    """A configured lattice-Boltzmann simulation: params + obstacle geometry."""

    def __init__(self, params: LBMParams, obstacles: np.ndarray):
        obstacles = np.asarray(obstacles)
        if obstacles.shape != (params.ny, params.nx):
            raise ValueError(
                f"obstacle mask shape {obstacles.shape} != grid "
                f"({params.ny}, {params.nx})"
            )
        self.params = params
        self.obstacles = obstacles
        enable_compile_cache()

    @classmethod
    def from_files(cls, paramfile, obstaclefile) -> "Simulation":
        from lbm_tpu.io import read_obstacles, read_params

        params = read_params(paramfile)
        return cls(params, read_obstacles(obstaclefile, params))

    def run(
        self,
        *,
        backend: str = "auto",
        dtype=None,
        mesh: int | tuple[int, int] = 0,
        **kwargs,
    ) -> SimulationResult:
        """Run ``max_iters`` steps. ``mesh`` shards over N devices (int) or a
        2-D (py, px) mesh; extra kwargs pass through to the driver
        (checkpointing, resume, chunk callbacks...)."""
        import jax.numpy as jnp

        dtype = dtype if dtype is not None else jnp.float32
        if isinstance(mesh, tuple):
            from lbm_tpu.parallel.sharded import run_simulation_sharded_2d

            # Checkpoint/resume/chunking kwargs thread through like the 1-D
            # path; anything the 2-D runner doesn't take raises TypeError
            # loudly rather than being dropped.
            return run_simulation_sharded_2d(
                self.params, self.obstacles, mesh_shape=mesh, backend=backend,
                dtype=dtype, **kwargs,
            )
        if mesh and mesh > 1:
            from lbm_tpu.parallel.sharded import run_simulation_sharded

            return run_simulation_sharded(
                self.params,
                self.obstacles,
                n_devices=mesh,
                backend=backend,
                dtype=dtype,
                **kwargs,
            )
        return run_simulation(
            self.params, self.obstacles, backend=backend, dtype=dtype, **kwargs
        )

    def reynolds(self, result: SimulationResult) -> float:
        return result.reynolds(self.params, self.obstacles)

    def velocity_field(self, result: SimulationResult):
        """(u_x, u_y, |u|, pressure) numpy fields of the final state."""
        import jax.numpy as jnp

        from lbm_tpu.ops.reference import velocity_field

        fields = velocity_field(jnp.asarray(result.cells), jnp.asarray(self.obstacles))
        return tuple(np.asarray(f) for f in fields)

    def write_outputs(self, result: SimulationResult, out_dir=".") -> None:
        from lbm_tpu.io import write_av_vels, write_final_state

        os.makedirs(out_dir, exist_ok=True)
        write_final_state(
            os.path.join(out_dir, "final_state.dat"),
            self.params,
            result.cells,
            self.obstacles,
        )
        write_av_vels(os.path.join(out_dir, "av_vels.dat"), result.av_vels)
