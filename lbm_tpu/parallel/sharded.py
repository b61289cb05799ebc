"""Multi-device domain decomposition over a JAX mesh.

The reference is strictly single-device (job_submit_d2q9-bgk:10 requests
``nodes=1:gpus=1``; the periodic wrap is modulo indexing inside one memory
space, kernels.cl:80-83). The scaling path here shards the lattice over a
device mesh with ``shard_map``:

- on a 1-D mesh each device owns a contiguous block of rows of all 9 speed
  planes; per step the pull-scheme streaming needs a one-row halo from each
  neighbor: the three north-pulling planes (2, 5, 6) need the previous
  shard's last row and the three south-pulling planes (4, 7, 8) need the
  next shard's first row. Both halos travel in ONE ``lax.ppermute`` each
  (planes stacked); the periodic boundary maps onto the ring of shards;
- a 2-D rows x cols mesh (``run_simulation_sharded_2d``) uses a two-phase
  column-then-row exchange that delivers corner values without explicit
  diagonal messages;
- the per-step mean-velocity reduction is a ``lax.psum``;
- the whole timestep loop stays inside one jitted ``shard_map``, so halo
  exchange compiles to XLA collective-permutes (NCCL on GPUs) with no host
  involvement.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lbm_tpu.models.d2q9 import LBMParams
from lbm_tpu.ops.reference import collide
from lbm_tpu.runtime.driver import (
    BACKENDS,
    SimulationResult,
    compute_chunk_sizes,
    initial_cells_for,
    inv_tot_cells_for,
    resolve_dtype,
    upload_obstacles,
)

AXIS = "y"
AXIS_X = "x"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D mesh over the row axis of the lattice, in device-list order
    (every card of an NVLink host reaches every other at the same rate)."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            if n_devices > len(devices):
                raise ValueError(
                    f"requested {n_devices} devices, only {len(devices)} available"
                )
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (AXIS,))


def make_mesh_2d(py: int, px: int, devices=None) -> Mesh:
    """A 2-D ``(y, x)`` mesh: rows sharded over ``py`` devices, columns over
    ``px`` (SURVEY.md §7.6: the 8192^2 weak-scaling layout)."""
    if devices is None:
        devices = jax.devices()
    if py * px > len(devices):
        raise ValueError(f"requested {py}x{px} mesh, only {len(devices)} devices")
    return Mesh(np.asarray(devices[: py * px]).reshape(py, px), (AXIS, AXIS_X))


def _ring_shift(x, axis_name: str, direction: int):
    """ppermute ``x`` one step around the ring of ``axis_name``.
    direction=+1 sends to the next shard (i -> i+1), -1 to the previous."""
    n = jax.lax.axis_size(axis_name)
    perm = [(i, (i + direction) % n) for i in range(n)]
    return jax.lax.ppermute(x, axis_name, perm)


def _accelerate_local(cells, obstacles, density, accel, ny_global):
    """Row-``ny-2`` forcing (kernels.cl:7-42) applied by whichever shard owns
    that global row, via a global-row mask."""
    dtype = cells.dtype
    ny_local = cells.shape[1]
    row_offset = jax.lax.axis_index(AXIS) * ny_local
    local_rows = jax.lax.broadcasted_iota(jnp.int32, (ny_local, 1), 0) + row_offset
    row_mask = (local_rows == ny_global - 2).astype(dtype)  # (ny_local, 1)

    w1 = jnp.asarray(density * accel / 9.0, dtype=dtype)
    w2 = jnp.asarray(density * accel / 36.0, dtype=dtype)
    free = (obstacles == 0).astype(dtype)
    ok = (
        (cells[3] - w1 > 0.0) & (cells[6] - w2 > 0.0) & (cells[7] - w2 > 0.0)
    ).astype(dtype)
    m = free * ok * row_mask  # (ny_local, nx)

    zero = jnp.zeros_like(m)
    delta = jnp.stack(
        [zero, w1 * m, zero, -w1 * m, zero, w2 * m, -w2 * m, -w2 * m, w2 * m]
    )
    return cells + delta


def _shift_rows(xs):
    """y-shifts of the (already x-shifted) planes ``xs``, splicing in one
    halo row from each ring neighbor."""
    # Planes pulling from the row below (global y-1): need prev shard's last row.
    south = _ring_shift(jnp.stack([xs[2][-1:], xs[5][-1:], xs[6][-1:]]), AXIS, +1)
    # Planes pulling from the row above (global y+1): need next shard's first row.
    north = _ring_shift(jnp.stack([xs[4][:1], xs[7][:1], xs[8][:1]]), AXIS, -1)

    def down(p, halo):  # tmp[r] = p[r-1]
        return jnp.concatenate([halo, p[:-1]], axis=0)

    def up(p, halo):  # tmp[r] = p[r+1]
        return jnp.concatenate([p[1:], halo], axis=0)

    return jnp.stack(
        [
            xs[0],
            xs[1],
            down(xs[2], south[0]),
            xs[3],
            up(xs[4], north[0]),
            down(xs[5], south[1]),
            down(xs[6], south[2]),
            up(xs[7], north[1]),
            up(xs[8], north[2]),
        ]
    )


def _stream_local(cells):
    """Streaming on a 1-D row mesh: x-rolls are local (each shard holds full
    rows), y-shifts splice in one halo row from each ring neighbor."""
    xs = [cells[k] for k in range(9)]
    for k, cx in ((1, 1), (3, -1), (5, 1), (6, -1), (7, -1), (8, 1)):
        xs[k] = jnp.roll(cells[k], cx, axis=1)
    return _shift_rows(xs)


def _stream_local_2d(cells):
    """Streaming on a 2-D mesh: phase 1 exchanges one boundary COLUMN per
    x-direction and applies the x-shifts; phase 2 exchanges one boundary ROW
    of the already-x-shifted planes per y-direction. Corner values arrive
    correctly because the y-halo rows are taken from neighbors' x-shifted
    planes (whose edge columns already hold their x-neighbors' data — i.e.
    our diagonal neighbors')."""
    # Planes 1,5,8 pull from x-1 (need left neighbor's last column); planes
    # 3,6,7 pull from x+1 (right neighbor's first column).
    east = _ring_shift(jnp.stack([cells[k][:, -1:] for k in (1, 5, 8)]), AXIS_X, +1)
    west = _ring_shift(jnp.stack([cells[k][:, :1] for k in (3, 6, 7)]), AXIS_X, -1)
    xs = [cells[k] for k in range(9)]
    for i, k in enumerate((1, 5, 8)):  # tmp[., x] = p[., x-1]
        xs[k] = jnp.concatenate([east[i], cells[k][:, :-1]], axis=1)
    for i, k in enumerate((3, 6, 7)):  # tmp[., x] = p[., x+1]
        xs[k] = jnp.concatenate([cells[k][:, 1:], west[i]], axis=1)
    return _shift_rows(xs)


def lbm_step_sharded(cells, obstacles, density, accel, omega, ny_global):
    """One timestep of the local shard on a 1-D row mesh (runs inside
    shard_map). Returns ``(new_cells, tot_u_global)`` — the reduction is
    already psum'd across the mesh."""
    cells = _accelerate_local(cells, obstacles, density, accel, ny_global)
    new_cells, tot_u_local = collide(_stream_local(cells), obstacles, omega)
    return new_cells, jax.lax.psum(tot_u_local, AXIS)


def lbm_step_sharded_2d(cells, obstacles, density, accel, omega, ny_global):
    """One timestep of the local shard on a 2-D ``(y, x)`` mesh."""
    cells = _accelerate_local(cells, obstacles, density, accel, ny_global)
    new_cells, tot_u_local = collide(_stream_local_2d(cells), obstacles, omega)
    return new_cells, jax.lax.psum(tot_u_local, (AXIS, AXIS_X))


def _c16_step(step, dev):
    """Wrap a per-shard step in c16 decode → step → encode, mirroring
    ``devspace.lbm_step_reference_c16`` for the single-device driver."""
    from lbm_tpu.ops.devspace import DevSpec, decode_state, encode_state

    spec = DevSpec(bg=tuple(dev[:9]), h=float(dev[9]))

    def wrapped(state, obstacles, density, accel, omega, ny_global):
        new, tot_u = step(decode_state(state, spec), obstacles, density, accel,
                          omega, ny_global)
        return encode_state(new, spec), tot_u

    return wrapped


def _build_loop(mesh, params, step, cells_spec, obst_spec, n_iters):
    """The jitted sharded run: ``step`` (a per-shard step taking
    ``ny_global`` last) inside one ``fori_loop`` inside one ``shard_map``,
    av_vels replicated."""
    ny_global = params.ny
    density = float(params.density)
    accel = float(params.accel)
    omega = float(params.omega)
    n_iters = params.max_iters if n_iters is None else n_iters

    def local_loop(cells, obstacles, inv_tot_cells):
        # The mean-velocity series stays f32 under the 16-bit storage modes
        # (bf16 and c16/int16), matching the single-device driver.
        av_dtype = (
            cells.dtype
            if cells.dtype in (jnp.float32, jnp.float64)
            else jnp.float32
        )

        def body(tt, carry):
            cells, av_vels = carry
            cells, tot_u = step(cells, obstacles, density, accel, omega, ny_global)
            av_vels = av_vels.at[tt].set((tot_u * inv_tot_cells).astype(av_dtype))
            return cells, av_vels

        av_vels = jnp.zeros((n_iters,), dtype=av_dtype)
        return jax.lax.fori_loop(0, n_iters, body, (cells, av_vels))

    mapped = jax.shard_map(
        local_loop,
        mesh=mesh,
        in_specs=(cells_spec, obst_spec, P()),
        out_specs=(cells_spec, P()),
    )
    return jax.jit(mapped, donate_argnums=(0,))


def build_sharded_loop(mesh: Mesh, params: LBMParams, step_fn=None, n_iters=None):
    """The jitted run on a 1-D row mesh: cells and obstacles sharded
    row-wise. ``step_fn`` is a per-shard step with ``lbm_step_sharded``'s
    signature (default: that step). ``n_iters`` overrides
    ``params.max_iters``."""
    return _build_loop(mesh, params, step_fn or lbm_step_sharded,
                       P(None, AXIS, None), P(AXIS, None), n_iters)


def pick_shard_step(backend: str, dev=None, two_d: bool = False):
    """The per-shard step: the jnp step for the mesh's rank, wrapped in
    decode/encode when ``dev`` (the c16 companding tuple) is given."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    step = lbm_step_sharded_2d if two_d else lbm_step_sharded
    return step if dev is None else _c16_step(step, dev)


def _run_on_mesh(params, obstacles, mesh, *, two_d, backend, dtype,
                 initial_cells, start_step, av_vels_prefix, checkpoint_every,
                 checkpoint_path, checkpoint_format):
    dtype, dev_spec = resolve_dtype(params, dtype)
    dev_tuple = None if dev_spec is None else (*dev_spec.bg, dev_spec.h)
    step = pick_shard_step(backend, dev_tuple, two_d=two_d)
    cells_spec = P(None, AXIS, AXIS_X) if two_d else P(None, AXIS, None)
    obst_spec = P(AXIS, AXIS_X) if two_d else P(AXIS, None)

    cells = jax.device_put(
        initial_cells_for(params, dtype, dev_spec, initial_cells),
        NamedSharding(mesh, cells_spec),
    )
    obstacles_dev = jax.device_put(
        upload_obstacles(np.asarray(obstacles)), NamedSharding(mesh, obst_spec)
    )
    inv_tot_cells = inv_tot_cells_for(obstacles, dtype)

    if params.max_iters - start_step <= 0:
        raise ValueError("start_step is beyond max_iters")
    av_chunks = [] if av_vels_prefix is None else [np.asarray(av_vels_prefix)]
    chunk_sizes = compute_chunk_sizes(start_step, params.max_iters, checkpoint_every)

    t0 = time.perf_counter()
    compiled = {
        n: _build_loop(mesh, params, step, cells_spec, obst_spec, n)
        .lower(cells, obstacles_dev, inv_tot_cells)
        .compile()
        for n in sorted(set(chunk_sizes))
    }
    compile_time = time.perf_counter() - t0

    def as_full(state):
        if dev_spec is None:
            return state
        from lbm_tpu.ops.devspace import decode_state

        return decode_state(state, dev_spec)

    elapsed = 0.0
    step_count = start_step
    for n in chunk_sizes:
        t0 = time.perf_counter()
        cells, av = compiled[n](cells, obstacles_dev, inv_tot_cells)
        jax.block_until_ready(cells)
        elapsed += time.perf_counter() - t0
        av_chunks.append(np.asarray(av))
        step_count += n
        if checkpoint_path is not None and checkpoint_every:
            from lbm_tpu.runtime.checkpoint import save_checkpoint_as

            save_checkpoint_as(
                checkpoint_path, params, np.asarray(as_full(cells)),
                np.concatenate(av_chunks), step_count, format=checkpoint_format,
            )

    return SimulationResult(
        cells=np.asarray(as_full(cells)),
        av_vels=np.concatenate(av_chunks),
        elapsed=elapsed,
        compile_time=compile_time,
    )


def run_simulation_sharded(
    params: LBMParams,
    obstacles: np.ndarray,
    *,
    n_devices: int | None = None,
    backend: str = "auto",
    dtype=jnp.float32,
    initial_cells: np.ndarray | None = None,
    start_step: int = 0,
    av_vels_prefix: np.ndarray | None = None,
    checkpoint_every: int = 0,
    checkpoint_path: str | None = None,
    checkpoint_format: str = "npz",
):
    """Run the full simulation over a 1-D row mesh of ``n_devices`` (default
    all). Requires ``ny`` divisible by the number of devices.
    Checkpoint/resume mirrors the single-device driver (chunked loop;
    resumable state gathered to host per snapshot). ``dtype="c16"`` selects
    companded-deviation storage (ops/devspace.py); checkpoints and the
    returned state are decoded f32."""
    mesh = make_mesh(n_devices)
    n = mesh.devices.size
    if params.ny % n != 0:
        raise ValueError(f"ny={params.ny} not divisible by {n} devices")
    return _run_on_mesh(
        params, obstacles, mesh, two_d=False, backend=backend, dtype=dtype,
        initial_cells=initial_cells, start_step=start_step,
        av_vels_prefix=av_vels_prefix, checkpoint_every=checkpoint_every,
        checkpoint_path=checkpoint_path, checkpoint_format=checkpoint_format,
    )


def run_simulation_sharded_2d(
    params: LBMParams,
    obstacles: np.ndarray,
    *,
    mesh_shape: tuple[int, int],
    backend: str = "auto",
    dtype=jnp.float32,
    initial_cells: np.ndarray | None = None,
    start_step: int = 0,
    av_vels_prefix: np.ndarray | None = None,
    checkpoint_every: int = 0,
    checkpoint_path: str | None = None,
    checkpoint_format: str = "npz",
):
    """Run the full simulation over a 2-D ``(py, px)`` device mesh, with the
    same checkpoint/resume/c16 surface as ``run_simulation_sharded``."""
    py, px = mesh_shape
    mesh = make_mesh_2d(py, px)
    if params.ny % py != 0 or params.nx % px != 0:
        raise ValueError(
            f"grid {params.ny}x{params.nx} not divisible by mesh {py}x{px}"
        )
    return _run_on_mesh(
        params, obstacles, mesh, two_d=True, backend=backend, dtype=dtype,
        initial_cells=initial_cells, start_step=start_step,
        av_vels_prefix=av_vels_prefix, checkpoint_every=checkpoint_every,
        checkpoint_path=checkpoint_path, checkpoint_format=checkpoint_format,
    )
