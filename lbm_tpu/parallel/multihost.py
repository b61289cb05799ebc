"""Multi-process initialization.

The reference is single-node by construction (job_submit_d2q9-bgk:10). For a
run spanning several processes (several hosts, or one process per GPU), JAX
needs ``jax.distributed.initialize`` before first device use; the mesh in
``lbm_tpu.parallel.sharded`` then spans all global devices.

Configuration comes from the standard JAX env vars (set by most launchers):
``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID`` —
or explicit arguments.
"""

from __future__ import annotations

import os


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize the distributed runtime. With no coordinator and no process
    count (neither as arguments nor in the environment) this is a no-op: a
    single-process run needs no distributed setup."""
    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])

    if coordinator_address is None and num_processes is None:
        return

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def run_simulation_multihost(params, obstacles, *, backend="auto", dtype=None):
    """Run the sharded simulation across ALL global devices of an initialized
    multi-process runtime (``initialize_multihost`` first).

    Every process calls this with the SAME params/obstacles; the lattice is
    row-sharded over the global 1-D mesh (``parallel.sharded``), each process
    feeds only its addressable shards (``jax.make_array_from_callback``), the
    per-step loop runs exactly as in the single-controller path (halo
    ppermutes + psum compile to cross-process collectives), and the result is
    gathered back so every process returns the identical full
    ``SimulationResult``. Checkpoint/resume stays single-controller-only.

    Validated end-to-end by tests/test_multihost.py's spawned 2-process CPU
    run (SURVEY.md §2.4, distributed-communication-backend row).
    """
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    from lbm_tpu.models.d2q9 import D2Q9
    from lbm_tpu.parallel import sharded as S
    from lbm_tpu.runtime.driver import SimulationResult

    import time

    if isinstance(dtype, str) and dtype == "c16":
        raise ValueError(
            "c16 storage is not supported on the multi-process path yet"
        )
    dtype = jnp.float32 if dtype is None else dtype
    mesh = S.make_mesh()  # all global devices on the row axis
    n = mesh.devices.size
    if params.ny % n != 0:
        raise ValueError(f"ny={params.ny} not divisible by {n} global devices")

    step_fn = S.pick_shard_step(backend)

    host_cells = np.asarray(D2Q9.initial_state(params, dtype=dtype))
    host_obst = np.asarray(obstacles, dtype=np.int32)
    cells = jax.make_array_from_callback(
        host_cells.shape,
        NamedSharding(mesh, P(None, S.AXIS, None)),
        lambda idx: host_cells[idx],
    )
    obstacles_dev = jax.make_array_from_callback(
        host_obst.shape,
        NamedSharding(mesh, P(S.AXIS, None)),
        lambda idx: host_obst[idx],
    )
    tot_cells = int(np.sum(host_obst == 0))
    inv_dtype = jnp.float32 if dtype == jnp.bfloat16 else dtype
    inv_tot_cells = jnp.asarray(1.0 / tot_cells, dtype=inv_dtype)

    loop = S.build_sharded_loop(mesh, params, step_fn=step_fn)
    t0 = time.perf_counter()
    compiled = loop.lower(cells, obstacles_dev, inv_tot_cells).compile()
    compile_time = time.perf_counter() - t0

    t0 = time.perf_counter()
    cells, av_vels = compiled(cells, obstacles_dev, inv_tot_cells)
    # av_vels is fully replicated — fetching it is the synchronization point.
    av_np = np.asarray(av_vels)
    elapsed = time.perf_counter() - t0

    cells_np = np.asarray(multihost_utils.process_allgather(cells, tiled=True))
    return SimulationResult(
        cells=cells_np,
        av_vels=av_np,
        elapsed=elapsed,
        compile_time=compile_time,
    )
