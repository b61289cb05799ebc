"""Simulation driver.

The reference drives the simulation from the host: per step it launches two
kernels, syncs the device, reads the whole ``tot_us`` buffer back over PCIe
and sums it on the CPU (d2q9-bgk.c:206-228, 408-420). Here the driver
compiles the ENTIRE run into one ``lax.fori_loop``: the carry is
``(cells, av_vels)`` with the per-step mean velocity scattered into an
on-device ``(maxIters,)`` array; nothing touches the host until the loop
finishes. The final state written out is the true last state (the reference
reads a one-step-stale buffer for even maxIters — d2q9-bgk.c:237-272 — a
quirk this driver deliberately does not reproduce).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from lbm_tpu.models.d2q9 import D2Q9, LBMParams
from lbm_tpu.ops.reference import lbm_step_reference

BACKENDS = ("auto", "reference")


@jax.jit
def _max_abs_code(q):
    """Max |companded int16 code| of a c16 state — the saturation probe."""
    return jnp.max(jnp.abs(q.astype(jnp.int32)))


@functools.partial(jax.jit, static_argnames=("ny", "nx"))
def _unpack_obstacles(packed, ny, nx):
    # np.packbits bit order: byte b holds cells 8b..8b+7 at bits 7..0.
    bits = (packed[:, None] >> jnp.arange(7, -1, -1, dtype=jnp.uint8)) & 1
    return bits.reshape(-1)[: ny * nx].reshape(ny, nx).astype(jnp.int32)


def upload_obstacles(obstacles: np.ndarray) -> jnp.ndarray:
    """Device int32 obstacle mask, shipped as 1 bit/cell and unpacked by a
    small jitted program: the host-to-device copy is 32x smaller than the
    dense int32 mask. Semantics are unchanged (nonzero = blocked,
    d2q9-bgk.c:596-631)."""
    ny, nx = obstacles.shape
    packed = np.packbits((obstacles != 0).reshape(-1))
    return _unpack_obstacles(jnp.asarray(packed), ny, nx)


@dataclasses.dataclass
class SimulationResult:
    cells: np.ndarray | None  # (9, ny, nx) final state (None: fetch_final=False)
    av_vels: np.ndarray  # (maxIters,) per-step mean |u| over unblocked cells
    elapsed: float  # wall-clock seconds for the compute loop (excl. compile)
    compile_time: float  # seconds spent compiling

    def mlups(self, params: LBMParams) -> float:
        return params.nx * params.ny * params.max_iters / self.elapsed / 1e6

    def reynolds(self, params: LBMParams, obstacles: np.ndarray) -> float:
        """Reynolds number from the final state (d2q9-bgk.c:815-819):
        mean |u| over unblocked cells * reynolds_dim / viscosity."""
        from lbm_tpu.ops.reference import velocity_field

        _, _, speed, _ = velocity_field(jnp.asarray(self.cells), jnp.asarray(obstacles))
        free = np.asarray(obstacles) == 0
        av = float(jnp.sum(speed * jnp.asarray(free, speed.dtype))) / int(free.sum())
        return params.reynolds(av)


def select_step_fn(params: LBMParams, backend: str, dtype=jnp.float32) -> tuple[Callable, str]:
    """Resolve the per-step implementation: ``(step_fn, name)``.

    Every backend runs the jnp step (``ops/reference.py``), which XLA compiles
    for whatever device JAX finds. ``auto`` is where a device-specific kernel
    joins once one wins on the card. c16 storage (int16 companded deviations)
    wraps the step in decode/encode.
    """
    del params  # the choice of kernel will depend on the grid once there is one
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if jnp.dtype(dtype) == jnp.dtype(jnp.int16):
        from lbm_tpu.ops.devspace import lbm_step_reference_c16

        return lbm_step_reference_c16, "reference-c16"
    return lbm_step_reference, "reference"


@functools.partial(
    jax.jit,
    static_argnames=("n_iters", "density", "accel", "omega", "step_fn", "dev"),
    donate_argnums=(0,),
)
def _run_loop(cells, obstacles, inv_tot_cells, n_iters, density, accel, omega,
              step_fn, dev=None):
    # ``dev`` is the c16 companding tuple, given exactly when the state is
    # int16 companded storage.
    call_step = step_fn if dev is None else functools.partial(step_fn, dev=dev)
    # The mean-velocity series stays f32 under the 16-bit storage modes
    # (bf16 and c16/int16).
    av_dtype = (
        cells.dtype
        if cells.dtype in (jnp.float32, jnp.float64)
        else jnp.float32
    )
    av_vels = jnp.zeros((n_iters,), dtype=av_dtype)

    def body(tt, carry):
        cells, av_vels = carry
        cells, tot_u = call_step(cells, obstacles, density, accel, omega)
        av_vels = av_vels.at[tt].set((tot_u * inv_tot_cells).astype(av_dtype))
        return cells, av_vels

    return jax.lax.fori_loop(0, n_iters, body, (cells, av_vels))


def compute_chunk_sizes(
    start_step: int, max_iters: int, checkpoint_every: int = 0, chunk_every: int = 0
) -> list[int]:
    """Split ``[start_step, max_iters)`` so a boundary falls on every
    multiple of ``checkpoint_every`` and of ``chunk_every`` (each ignored
    when <= 0)."""
    strides = [s for s in (checkpoint_every, chunk_every) if s and s > 0]
    if not strides:
        return [max_iters - start_step]
    sizes = []
    step = start_step
    while step < max_iters:
        nxt = min(
            [max_iters] + [(step // s + 1) * s for s in strides]
        )
        sizes.append(nxt - step)
        step = nxt
    return sizes


def initial_cells_for(params: LBMParams, dtype, dev_spec, initial_cells=None):
    """Host-side initial state in storage form: the at-rest equilibrium or
    ``initial_cells``, encoded to int16 deviations when ``dev_spec`` (c16)
    is given."""
    if dev_spec is None:
        if initial_cells is None:
            return D2Q9.initial_state(params, dtype=dtype)
        return jnp.asarray(initial_cells, dtype=dtype)
    from lbm_tpu.ops.devspace import encode_state

    full = (
        D2Q9.initial_state(params, dtype=jnp.float32)
        if initial_cells is None
        else jnp.asarray(initial_cells, dtype=jnp.float32)
    )
    return encode_state(full, dev_spec)


def resolve_dtype(params: LBMParams, dtype):
    """``(storage dtype, DevSpec or None)``: ``"c16"`` means int16 companded
    deviation storage (ops/devspace.py)."""
    if isinstance(dtype, str) and dtype == "c16":
        from lbm_tpu.ops.devspace import DevSpec

        return jnp.int16, DevSpec.for_params(params.density, params.accel)
    return dtype, None


def inv_tot_cells_for(obstacles: np.ndarray, dtype):
    """``1 / (number of unblocked cells)`` (d2q9-bgk.c:146-152), in the
    av_vels accumulation dtype."""
    tot_cells = int(np.sum(np.asarray(obstacles) == 0))
    inv_dtype = dtype if dtype in (jnp.float32, jnp.float64) else jnp.float32
    return jnp.asarray(1.0 / tot_cells, dtype=inv_dtype)


def warn_if_saturated(cells, dev_spec) -> None:
    """c16 failure detection: H leaves ~4x headroom over the observed
    per-config maxima, so a final state near the clamp means the companding
    range was exceeded mid-run and accuracy is suspect. The companded decode
    is monotone in |q|, so max|deviation| comes from an on-device int16
    reduction and one scalar fetch, never a state transfer."""
    from lbm_tpu.ops.devspace import LIM

    maxq = float(_max_abs_code(cells))
    md = (maxq / LIM) ** 2 * dev_spec.h
    if md > 0.5 * dev_spec.h:
        import warnings

        warnings.warn(
            f"c16 deviations reached {md:.3g} (companding range "
            f"H={dev_spec.h:.3g}) — results may have saturated; rerun "
            "with f32 or a larger LBM_C16_H",
            stacklevel=3,
        )


def run_simulation(
    params: LBMParams,
    obstacles: np.ndarray,
    *,
    backend: str = "auto",
    dtype=jnp.float32,
    initial_cells: np.ndarray | None = None,
    start_step: int = 0,
    av_vels_prefix: np.ndarray | None = None,
    checkpoint_every: int = 0,
    checkpoint_path: str | None = None,
    checkpoint_format: str = "npz",
    chunk_every: int = 0,
    on_chunk=None,
    device=None,
    fetch_final: bool = True,
) -> SimulationResult:
    """Run steps ``start_step .. params.max_iters`` and return the result.

    ``initial_cells`` / ``start_step`` / ``av_vels_prefix`` support resuming
    from a checkpoint (see ``runtime.checkpoint``); ``checkpoint_every`` > 0
    snapshots state every K steps by splitting the device loop into chunks.
    ``chunk_every``/``on_chunk`` split the loop for observation without
    checkpointing (e.g. per-step debug reports): ``on_chunk(step, cells,
    av_chunk)`` is called after each chunk with the completed step count.

    ``dtype="c16"`` selects companded-16-bit deviation storage
    (ops/devspace.py): half the state traffic of f32 with golden-gate-passing
    accuracy (unlike bf16). Checkpoints, chunk callbacks and the returned
    state are decoded f32.

    ``fetch_final=False`` skips copying the final state to the host
    (``result.cells`` is None), for timing runs that only read
    ``elapsed``/``av_vels``.
    """
    dtype, dev_spec = resolve_dtype(params, dtype)
    step_fn, _ = select_step_fn(params, backend, dtype)

    cells = initial_cells_for(params, dtype, dev_spec, initial_cells)
    obstacles_dev = upload_obstacles(np.asarray(obstacles))
    if device is not None:
        cells = jax.device_put(cells, device)
        obstacles_dev = jax.device_put(obstacles_dev, device)
    inv_tot_cells = inv_tot_cells_for(obstacles, dtype)
    # Static (hashable) form of the c16 companding spec for the step.
    dev_tuple = None if dev_spec is None else (*dev_spec.bg, dev_spec.h)

    remaining = params.max_iters - start_step
    if remaining <= 0:
        raise ValueError("start_step is beyond max_iters")
    av_chunks = [] if av_vels_prefix is None else [np.asarray(av_vels_prefix)]

    # Chunk boundaries land on every multiple of checkpoint_every AND of
    # chunk_every (not a fixed stride: checkpoint_every=100 with
    # chunk_every=30 must still checkpoint at 100, 200, ... and an unaligned
    # resume realigns at the next multiple).
    chunk_sizes = compute_chunk_sizes(
        start_step, params.max_iters, checkpoint_every, chunk_every
    )

    # Compile up front (one compile per distinct chunk size, AOT — no
    # execution) so `elapsed` measures only the compute loop — the analogue of
    # the reference timing the loop but not the OpenCL program build
    # (d2q9-bgk.c:155-156).
    t0 = time.perf_counter()
    compiled = {
        n: _run_loop.lower(
            cells, obstacles_dev, inv_tot_cells, n_iters=n,
            density=float(params.density), accel=float(params.accel),
            omega=float(params.omega), step_fn=step_fn, dev=dev_tuple,
        ).compile()
        for n in sorted(set(chunk_sizes))
    }
    compile_time = time.perf_counter() - t0

    def as_full(state):
        """Observer view of the state: c16 storage decodes to f32."""
        if dev_spec is None:
            return state
        from lbm_tpu.ops.devspace import decode_state

        return decode_state(state, dev_spec)

    elapsed = 0.0
    step = start_step
    for n in chunk_sizes:
        t0 = time.perf_counter()
        cells, av = compiled[n](cells, obstacles_dev, inv_tot_cells)
        jax.block_until_ready(cells)
        elapsed += time.perf_counter() - t0
        av_chunks.append(np.asarray(av))
        step += n
        if on_chunk is not None:
            on_chunk(step, as_full(cells), av_chunks[-1])
        if (
            checkpoint_path is not None
            and checkpoint_every
            and (step % checkpoint_every == 0 or step == params.max_iters)
        ):
            from lbm_tpu.runtime.checkpoint import save_checkpoint_as

            # c16 checkpoints store the decoded f32 state (the format stays
            # storage-agnostic; resume re-encodes, an exact round-trip up to
            # possible single-quantum rint boundary flips).
            save_checkpoint_as(
                checkpoint_path, params, np.asarray(as_full(cells)),
                np.concatenate(av_chunks), step, format=checkpoint_format,
            )

    final_cells = np.asarray(as_full(cells)) if fetch_final else None
    if dev_spec is not None:
        warn_if_saturated(cells, dev_spec)
    return SimulationResult(
        cells=final_cells,
        av_vels=np.concatenate(av_chunks),
        elapsed=elapsed,
        compile_time=compile_time,
    )
