"""The four reference decks and their in-tree golds.

The reference ships four params/obstacle pairs (SURVEY.md §2.1). This table
rebuilds them in-process from the geometry generators, so tests, the
benchmark and the smoke script need no input files on disk. Each deck's gold
is ``tests/golden/<tag>.golden.npz``: an f64 rerun's ``av_vels`` series and
final pressure field (``scripts/make_golden.py``), materialised in the
reference's file formats by ``write_gold_files`` for the checker.
"""

from __future__ import annotations

import os

import numpy as np

from lbm_tpu.models.d2q9 import LBMParams
from lbm_tpu.utils.geometry import (
    box,
    box_with_vertical_wall,
    channel_with_divider,
    write_obstacle_file,
    write_params_file,
)

# (nx, ny, maxIters, reynolds_dim, density, accel, omega), geometry builder
CONFIGS = {
    "128x128": ((128, 128, 40000, 10, 0.1, 0.005, 1.85), lambda: box(128, 128)),
    "128x256": (
        (128, 256, 40000, 10, 0.1, 0.005, 1.85),
        lambda: channel_with_divider(128, 256),
    ),
    "256x256": ((256, 256, 80000, 10, 0.1, 0.005, 1.85), lambda: box(256, 256)),
    "1024x1024": (
        (1024, 1024, 20000, 10, 0.1, 0.01, 1.85),
        lambda: box_with_vertical_wall(1024, 1024, wall_col=341),
    ),
}

GOLDEN_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "tests",
    "golden",
)


def deck_params(tag: str) -> LBMParams:
    nx, ny, max_iters, reynolds_dim, density, accel, omega = CONFIGS[tag][0]
    return LBMParams(nx=nx, ny=ny, max_iters=max_iters, reynolds_dim=reynolds_dim,
                     density=density, accel=accel, omega=omega)


def deck_obstacles(tag: str) -> np.ndarray:
    return CONFIGS[tag][1]()


def write_deck(tag: str, outdir) -> tuple[str, str]:
    """Write ``input_<tag>.params`` + ``obstacles_<tag>.dat``; returns paths."""
    os.makedirs(outdir, exist_ok=True)
    params = os.path.join(outdir, f"input_{tag}.params")
    obstacles = os.path.join(outdir, f"obstacles_{tag}.dat")
    write_params_file(params, *CONFIGS[tag][0])
    write_obstacle_file(obstacles, deck_obstacles(tag))
    return params, obstacles


def load_gold(tag: str, gold_dir: str = GOLDEN_DIR):
    """The committed gold of ``tag`` as an ``np.load`` mapping."""
    return np.load(os.path.join(gold_dir, f"{tag}.golden.npz"))


def write_gold_files(tag: str, outdir, gold_dir: str = GOLDEN_DIR) -> tuple[str, str]:
    """Materialise the gold of ``tag`` as ``av_vels.dat`` / ``final_state.dat``
    files for the checker. The u columns are zero: the checker reads columns
    0, 1 and 5 (x, y, pressure) only (check/check.py:66)."""
    gold = load_gold(tag, gold_dir)
    pressure = gold["pressure"]
    ny, nx = pressure.shape
    os.makedirs(outdir, exist_ok=True)
    av_path = os.path.join(outdir, f"{tag}.gold_av_vels.dat")
    fs_path = os.path.join(outdir, f"{tag}.gold_final_state.dat")
    with open(av_path, "w") as f:
        f.write("".join("%d:\t%.12E\n" % (i, v) for i, v in enumerate(gold["av_vels"])))
    with open(fs_path, "w") as f:
        f.write("".join(
            "%d %d 0 0 0 %.12E 0\n" % (x, y, pressure[y, x])
            for y in range(ny) for x in range(nx)
        ))
    return av_path, fs_path
