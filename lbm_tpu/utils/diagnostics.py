"""Runtime diagnostics.

Mirrors the reference's debug facilities: ``total_density`` mass-conservation
check and the per-step ``==timestep==`` report compiled under ``-DDEBUG``
(d2q9-bgk.c:229-233, 822-838), plus NaN guarding the reference lacks
(SURVEY.md §5: jax.debug/checkify-style guards).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def total_density(cells) -> float:
    """Sum of all distributions — conserved by stream+collide+bounce-back
    (d2q9-bgk.c:822-838)."""
    return float(jnp.sum(jnp.asarray(cells)))


def debug_report(step: int, av_vel: float, cells) -> str:
    """The reference's per-step DEBUG block (d2q9-bgk.c:229-233)."""
    return (
        f"==timestep: {step}==\n"
        f"av velocity: {av_vel:.12E}\n"
        f"tot density: {total_density(cells):.12E}"
    )


class NaNError(RuntimeError):
    pass


def check_finite(av_vels, cells=None, *, context: str = "") -> None:
    """Fail fast if the simulation has gone non-finite (the checker would
    reject it anyway, check.py:134-135 — this catches it at the source)."""
    av = np.asarray(av_vels)
    if not np.isfinite(av).all():
        first = int(np.argmax(~np.isfinite(av)))
        raise NaNError(
            f"non-finite mean velocity at step {first}"
            + (f" ({context})" if context else "")
        )
    if cells is not None and not np.isfinite(np.asarray(cells)).all():
        raise NaNError("non-finite distribution state" + (f" ({context})" if context else ""))
