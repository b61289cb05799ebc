"""Pure-jnp reference implementation of the D2Q9/BGK timestep.

This is the step every backend runs today and the correctness oracle for any
device-specific kernel that joins it. Semantics mirror the reference's two
OpenCL kernels exactly:

- ``accelerate_flow`` — kernels.cl:7-42: on row ``ny-2``, where the cell is
  unblocked AND all three west-going populations stay strictly positive after
  the update, add ``w1=density*accel/9`` to speed 1 and ``w2=density*accel/36``
  to speeds 5,8, subtracting the same from 3,6,7. The three positivity
  conditions and the obstacle test form ONE joint mask (kernels.cl:29-32).
- ``comp_func`` — kernels.cl:44-201: pull-scheme streaming with periodic
  wrap, bounce-back on obstacles (opposite-direction copy of the *streamed*
  values), BGK relaxation toward the second-order equilibrium elsewhere, and
  the per-cell velocity magnitude ``nobst * |u|`` for the mean-velocity
  series.

State is ``(9, ny, nx)``; everything is functional (no in-place buffers —
XLA's double-buffering replaces the reference's explicit cells/tmp_cells
ping-pong, d2q9-bgk.c:206-228).
"""

from __future__ import annotations

import jax.numpy as jnp

from lbm_tpu.models.d2q9 import C_SQ, CX, CY, OPPOSITE, D2Q9


def accelerate_flow(cells, obstacles, density, accel):
    """Apply the lid forcing to row ``ny-2`` (kernels.cl:7-42).

    ``obstacles`` is the ``(ny, nx)`` int/bool mask. Returns updated cells.
    """
    dtype = cells.dtype
    w1 = jnp.asarray(density * accel / 9.0, dtype=dtype)
    w2 = jnp.asarray(density * accel / 36.0, dtype=dtype)
    row = cells.shape[1] - 2

    s = cells[:, row, :]  # (9, nx)
    free = obstacles[row, :] == 0
    # Joint mask: unblocked and the three decremented populations remain
    # strictly positive (kernels.cl:29-32).
    mask = free & (s[3] - w1 > 0.0) & (s[6] - w2 > 0.0) & (s[7] - w2 > 0.0)
    m = mask.astype(dtype)
    delta = jnp.stack(
        [
            jnp.zeros_like(m),
            w1 * m,
            jnp.zeros_like(m),
            -w1 * m,
            jnp.zeros_like(m),
            w2 * m,
            -w2 * m,
            -w2 * m,
            w2 * m,
        ]
    )
    return cells.at[:, row, :].add(delta)


def stream(cells):
    """Pull-scheme streaming with periodic wrap (kernels.cl:80-98).

    Speed k moves with velocity (CX[k], CY[k]); the pulled value at (y, x)
    comes from (y - CY[k], x - CX[k]) with wraparound, i.e. a roll of the
    plane by (+CY[k], +CX[k]).
    """
    return jnp.stack(
        [
            jnp.roll(cells[k], shift=(int(CY[k]), int(CX[k])), axis=(0, 1))
            for k in range(9)
        ]
    )


def collide(streamed, obstacles, omega):
    """Bounce-back + BGK collision + per-cell |u| (kernels.cl:100-198).

    Returns ``(new_cells, tot_u)`` where ``tot_u`` is the sum over unblocked
    cells of the velocity magnitude (the reference's ``tot_us`` buffer summed,
    d2q9-bgk.c:411-420 — here reduced on device).
    """
    dtype = streamed.dtype
    obst = (obstacles != 0)[None, :, :]

    rho, u_x, u_y = D2Q9.moments(streamed)
    feq = D2Q9.equilibrium(rho, u_x, u_y)
    relaxed = streamed + omega * (feq - streamed)
    bounced = streamed[OPPOSITE]
    new_cells = jnp.where(obst, bounced, relaxed).astype(dtype)

    speed = jnp.sqrt(u_x * u_x + u_y * u_y)
    nobst = (obstacles == 0).astype(dtype)
    tot_u = jnp.sum(nobst * speed)
    return new_cells, tot_u


def lbm_step_reference(cells, obstacles, density, accel, omega):
    """One full timestep (accelerate → stream → bounce/collide → reduce),
    the jnp step and oracle. Returns ``(new_cells, tot_u)``."""
    cells = accelerate_flow(cells, obstacles, density, accel)
    streamed = stream(cells)
    return collide(streamed, obstacles, omega)


def velocity_field(cells, obstacles):
    """Velocity moments with obstacle cells zeroed — the ``write_values`` /
    ``av_velocity`` convention (d2q9-bgk.c:426-475, 857-896)."""
    rho, u_x, u_y = D2Q9.moments(cells)
    free = (obstacles == 0).astype(cells.dtype)
    u_x = u_x * free
    u_y = u_y * free
    speed = jnp.sqrt(u_x * u_x + u_y * u_y)
    pressure = jnp.where(obstacles != 0, jnp.asarray(0.0, cells.dtype), rho * C_SQ)
    return u_x, u_y, speed, pressure
