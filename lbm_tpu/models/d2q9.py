"""The D2Q9 / BGK lattice model.

Defines the lattice constants, the equilibrium distribution, and the
simulation parameter record. The numbering convention, weights, and the
second-order equilibrium expansion reproduce the reference solver exactly
(kernels.cl:58-61, kernels.cl:137-177 in the upstream repo):

    speed 0: rest          weight 4/9
    speeds 1-4: E,N,W,S    weight 1/9   (east = +x, north = +y)
    speeds 5-8: NE,NW,SW,SE weight 1/36

The state tensor convention throughout the framework is a single
``(9, ny, nx)`` array ("speed planes" — the reference's structure-of-arrays
layout, d2q9-bgk.c:549-565 — with nx the contiguous minor axis).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

NSPEEDS = 9

# Lattice velocity components, indexed by speed. c[k] = (cx, cy) is the
# direction a population moves during streaming (kernels.cl:90-98 pull
# scheme: speed k at cell (ii,jj) is gathered from (ii - cy, jj - cx)).
CX = np.array([0, 1, 0, -1, 0, 1, -1, -1, 1], dtype=np.int32)
CY = np.array([0, 0, 1, 0, -1, 1, 1, -1, -1], dtype=np.int32)

# Opposite-direction map for bounce-back (kernels.cl:100-107):
# 1<->3, 2<->4, 5<->7, 6<->8.
OPPOSITE = np.array([0, 3, 4, 1, 2, 7, 8, 5, 6], dtype=np.int32)

# Quadrature weights (kernels.cl:59-61).
W0 = 4.0 / 9.0
W1 = 1.0 / 9.0
W2 = 1.0 / 36.0
WEIGHTS = np.array([W0, W1, W1, W1, W1, W2, W2, W2, W2], dtype=np.float64)

# Square of the lattice speed of sound (kernels.cl:58).
C_SQ = 1.0 / 3.0


@dataclasses.dataclass(frozen=True)
class LBMParams:
    """Simulation parameters — the reference's 7-field params file
    (``t_param``, d2q9-bgk.c:23-32; parsed at d2q9-bgk.c:499-525)."""

    nx: int
    ny: int
    max_iters: int
    reynolds_dim: int
    density: float
    accel: float
    omega: float

    @property
    def viscosity(self) -> float:
        # d2q9-bgk.c:817
        return (2.0 / self.omega - 1.0) / 6.0

    def reynolds(self, av_velocity: float) -> float:
        # d2q9-bgk.c:819
        return av_velocity * self.reynolds_dim / self.viscosity


class D2Q9:
    """Stateless helpers for the D2Q9 model, usable from jnp and numpy."""

    NSPEEDS = NSPEEDS
    CX = CX
    CY = CY
    OPPOSITE = OPPOSITE
    WEIGHTS = WEIGHTS
    C_SQ = C_SQ

    @staticmethod
    def initial_state(params: LBMParams, dtype=jnp.float32) -> jnp.ndarray:
        """Uniform equilibrium-at-rest initial condition (d2q9-bgk.c:572-594):
        plane 0 <- density*4/9, planes 1-4 <- density/9, planes 5-8 <- density/36.
        Returns a ``(9, ny, nx)`` array."""
        w = jnp.asarray(WEIGHTS * params.density, dtype=dtype)
        return jnp.broadcast_to(
            w[:, None, None], (NSPEEDS, params.ny, params.nx)
        ).astype(dtype)

    @staticmethod
    def moments(cells: jnp.ndarray):
        """Density and velocity moments of a ``(9, ny, nx)`` state
        (kernels.cl:109-131). Returns ``(rho, u_x, u_y)``."""
        rho = jnp.sum(cells, axis=0)
        u_x = (cells[1] + cells[5] + cells[8] - (cells[3] + cells[6] + cells[7])) / rho
        u_y = (cells[2] + cells[5] + cells[6] - (cells[4] + cells[7] + cells[8])) / rho
        return rho, u_x, u_y

    @staticmethod
    def equilibrium(rho, u_x, u_y):
        """Second-order BGK equilibrium, all 9 speeds (kernels.cl:148-177).

        Written as the same algebraic expression the reference uses:
        ``w_k * rho * (1 + cu/c_sq + cu^2/(2 c_sq^2) - u_sq/(2 c_sq))``
        with cu = c_k . u. Returns a ``(9, ...)`` stack.
        """
        dtype = rho.dtype
        u_sq = u_x * u_x + u_y * u_y
        common = 1.0 - u_sq / (2.0 * C_SQ)
        cx = jnp.asarray(CX, dtype=dtype)
        cy = jnp.asarray(CY, dtype=dtype)
        w = jnp.asarray(WEIGHTS, dtype=dtype)
        # cu[k] = cx_k*u_x + cy_k*u_y, broadcast over the grid.
        cu = cx[:, None, None] * u_x[None] + cy[:, None, None] * u_y[None]
        feq = (
            w[:, None, None]
            * rho[None]
            * (common[None] + cu / C_SQ + (cu * cu) / (2.0 * C_SQ * C_SQ))
        )
        return feq.astype(dtype)
