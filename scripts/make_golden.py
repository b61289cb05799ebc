#!/usr/bin/env python
"""Generate the stand-in gold of a reference deck.

The upstream golden files were produced by a double-precision serial build
(SURVEY.md §2.1 "Golden references"). This tool plays that role in-tree: it
runs the deck from ``lbm_tpu.utils.decks`` through the float64 jnp path on the
CPU and writes ``<outdir>/<tag>.golden.npz`` holding the ``av_vels`` series,
the final pressure field (what the checker compares) and the final Reynolds
number.

Usage: python scripts/make_golden.py <tag> [outdir]   (default tests/golden)
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv) -> int:
    if not argv:
        print(__doc__)
        return 2
    tag = argv[0]

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from lbm_tpu.ops.reference import velocity_field
    from lbm_tpu.runtime.driver import run_simulation
    from lbm_tpu.utils.decks import GOLDEN_DIR, deck_obstacles, deck_params

    outdir = argv[1] if len(argv) > 1 else GOLDEN_DIR
    params = deck_params(tag)
    obstacles = deck_obstacles(tag)
    result = run_simulation(params, obstacles, backend="reference", dtype=jnp.float64)
    _, _, _, pressure = velocity_field(jnp.asarray(result.cells), jnp.asarray(obstacles))
    # Obstacle cells report density * c_sq, as final_state.dat does.
    pressure = np.where(obstacles != 0, params.density / 3.0, np.asarray(pressure))

    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, f"{tag}.golden.npz")
    np.savez_compressed(
        path,
        av_vels=np.asarray(result.av_vels, np.float64),
        pressure=pressure.astype(np.float64),
        reynolds=np.float64(result.reynolds(params, obstacles)),
    )
    print(f"wrote {path} (Reynolds {float(result.reynolds(params, obstacles)):.12E}, "
          f"{result.elapsed:.1f} s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
