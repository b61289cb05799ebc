#!/usr/bin/env python
"""Smoke test of the solver on NVIDIA GPUs: the main path, end to end, at full size.

    python chip_smoke.py              # one GPU: phases 1-4, then the result line
    python chip_smoke.py --four-gpus  # four GPUs: the mesh phase only

Phases on one GPU, in order; the first that fails ends the run with a
non-zero exit code and no result line:

1. device: JAX's first device must be a GPU (no CPU fallback);
2. the four reference decks at their full iteration counts through
   ``lbm_tpu.cli.main``, each checked against its in-tree gold at the
   reference checker's 1% gate, with av_vels within 0.5%;
3. c16 storage on the 1024x1024 deck through the CLI, same gate;
4. an HBM-size grid, 8192x8192 for 1000 steps through ``lbm_tpu.api``, in
   f32 and in f64 on the card: av_vels within the 1% gate at every step,
   total mass conserved (1e-5 relative in f32, 1e-12 in f64), all finite.

``--four-gpus`` runs the 8192x8192 deck on a 1-D mesh of 4 and a 2x2 mesh
(the runners behind the CLI's ``--mesh 4`` and ``--mesh 2x2``) against the
same deck on one card: the final state within 1e-6 and av_vels within 1e-5
relative, with each mesh's shards on four distinct cards.

The last line of stdout is one JSON object naming the device; the card's
name and power limit (``nvidia-smi``) are printed before any number.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

from lbm_tpu import cli
from lbm_tpu.api import Simulation
from lbm_tpu.models.d2q9 import WEIGHTS, LBMParams
from lbm_tpu.runtime.compile_cache import enable_compile_cache
from lbm_tpu.runtime.device import gpu_name_and_power_limit
from lbm_tpu.utils.checker import check_files
from lbm_tpu.utils.decks import CONFIGS, write_deck, write_gold_files
from lbm_tpu.utils.geometry import box

GATE_PCT = 1.0  # the reference checker's tolerance (check/check.py:26-31)
DECK_AV_PCT = 0.5  # the av_vels bound the golden tests assert
HBM_SIDE, HBM_STEPS = 8192, 1000
MASS_RTOL = {"float32": 1e-5, "float64": 1e-12}
MESH_STATE_ATOL, MESH_AV_RTOL = 1e-6, 1e-5


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def result_line(kind: str, count: int) -> str:
    return json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": count}})


def require_gpus(count: int):
    """Phase 1: the devices JAX found, which must be ``count`` or more GPUs."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        fail(f"JAX found no GPU (platform {devices[0].platform!r})")
    if len(devices) < count:
        fail(f"{count} GPUs needed, JAX found {len(devices)}")
    print(f"[device] {devices[0].platform} {devices[0].device_kind} x {len(devices)}")
    print(f"[device] nvidia-smi name, power.limit: {gpu_name_and_power_limit()}")
    return devices


def deck_phase(tag: str, workdir: str, precision: str = "f32") -> dict:
    """Run deck ``tag`` through the CLI and check it against its gold."""
    params_path, obst_path = write_deck(tag, os.path.join(workdir, tag))
    out = os.path.join(workdir, tag, precision)
    stats_path = os.path.join(out, "stats.json")
    os.makedirs(out, exist_ok=True)
    rc = cli.main([params_path, obst_path, "--precision", precision,
                   "--out-dir", out, "--stats-json", stats_path])
    if rc != 0:
        fail(f"{tag} {precision}: the CLI exited {rc}")
    with open(stats_path) as f:
        stats = json.load(f)
    gold_av, gold_fs = write_gold_files(tag, os.path.join(workdir, "gold"))
    check = check_files(os.path.join(out, "av_vels.dat"),
                        os.path.join(out, "final_state.dat"),
                        gold_av, gold_fs, tolerance=GATE_PCT)
    row = {
        "deck": tag, "precision": precision, "loop_s": stats["loop_s"],
        "compile_s": stats["compile_s"], "mlups": stats["mlups"],
        "av_max_diff_pct": check.av_vels.max_diff_pcnt,
        "fs_max_diff_pct": check.final_state.max_diff_pcnt,
    }
    print(f"[deck] {json.dumps(row)}")
    if not check.passed:
        fail(f"{tag} {precision}: outside the {GATE_PCT}% gate: {row}")
    if abs(check.av_vels.max_diff_pcnt) > DECK_AV_PCT:
        fail(f"{tag} {precision}: av_vels max diff above {DECK_AV_PCT}%: {row}")
    return row


def hbm_params(side: int, steps: int) -> LBMParams:
    return LBMParams(nx=side, ny=side, max_iters=steps, reynolds_dim=10,
                     density=0.1, accel=0.005, omega=1.85)


def initial_mass(params: LBMParams, dtype) -> float:
    """Mass of the at-rest initial state as stored in ``dtype``, in float64."""
    per_cell = sum(float(np.asarray(w * params.density, dtype=dtype)) for w in WEIGHTS)
    return per_cell * params.nx * params.ny


def hbm_phase(side: int = HBM_SIDE, steps: int = HBM_STEPS) -> dict:
    """The box deck at ``side``^2 through the API in f32, then in f64 on the
    same device: av_vels gate, mass conservation, finiteness."""
    import jax
    import jax.numpy as jnp

    params = hbm_params(side, steps)
    obstacles = box(side, side)
    runs = {}
    for dtype in (jnp.float32, jnp.float64):
        if dtype == jnp.float64:
            jax.config.update("jax_enable_x64", True)
        res = Simulation(params, obstacles).run(dtype=dtype)
        name = jnp.dtype(dtype).name
        if not (np.isfinite(res.cells).all() and np.isfinite(res.av_vels).all()):
            fail(f"{side}^2 {name}: non-finite values")
        m0 = initial_mass(params, dtype)
        mass_rel = (float(np.sum(res.cells, dtype=np.float64)) - m0) / m0
        runs[name] = res
        row = {"grid": f"{side}x{side}", "steps": steps, "dtype": name,
               "loop_s": res.elapsed, "compile_s": res.compile_time,
               "mlups": res.mlups(params), "mass_rel": mass_rel}
        print(f"[hbm] {json.dumps(row)}")
        if abs(mass_rel) > MASS_RTOL[name]:
            fail(f"{side}^2 {name}: mass drifted {mass_rel:.3e} "
                 f"(bound {MASS_RTOL[name]:.0e})")
    f32, f64 = runs["float32"].av_vels, runs["float64"].av_vels
    av_pct = float(np.max(np.abs(100.0 * (f64 - f32) / f32)))
    print(f"[hbm] av_vels f32 vs f64: max {av_pct:.3e}% (gate {GATE_PCT}%, "
          f"expected <= 0.1%)")
    if not av_pct <= GATE_PCT:
        fail(f"{side}^2: av_vels f32 vs f64 {av_pct:.3e}% > {GATE_PCT}%")
    return {"av_pct": av_pct}


def _distinct_shard_devices(mesh_arg) -> int:
    """How many distinct devices hold the shards of a state on ``mesh_arg``
    (an int for a 1-D mesh, a pair for a 2-D one), placed with the runners'
    own shardings."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from lbm_tpu.parallel.sharded import AXIS, AXIS_X, make_mesh, make_mesh_2d

    if isinstance(mesh_arg, tuple):
        sharding = NamedSharding(make_mesh_2d(*mesh_arg), P(None, AXIS, AXIS_X))
    else:
        sharding = NamedSharding(make_mesh(mesh_arg), P(None, AXIS, None))
    x = jax.device_put(jnp.zeros((9, 64, 64), jnp.float32), sharding)
    return len({shard.device for shard in x.addressable_shards})


def mesh_phase(side: int = HBM_SIDE, steps: int = HBM_STEPS,
               meshes=(4, (2, 2))) -> list:
    """The box deck at ``side``^2 on each mesh against one device."""
    params = hbm_params(side, steps)
    obstacles = box(side, side)
    sim = Simulation(params, obstacles)
    single = sim.run()
    rows = []
    for mesh in meshes:
        n_cards = mesh[0] * mesh[1] if isinstance(mesh, tuple) else mesh
        placed = _distinct_shard_devices(mesh)
        res = sim.run(mesh=mesh)
        state_diff = float(np.max(np.abs(res.cells - single.cells)))
        av_rel = float(np.max(np.abs(res.av_vels - single.av_vels)
                              / np.abs(single.av_vels)))
        row = {"mesh": "x".join(map(str, mesh)) if isinstance(mesh, tuple) else str(mesh),
               "grid": f"{side}x{side}", "steps": steps,
               "devices_holding_shards": placed, "loop_s": res.elapsed,
               "single_loop_s": single.elapsed, "mlups": res.mlups(params),
               "state_max_abs_diff": state_diff, "av_max_rel_diff": av_rel}
        print(f"[mesh] {json.dumps(row)}")
        if placed != n_cards:
            fail(f"mesh {row['mesh']}: shards on {placed} devices, not {n_cards}")
        if not (state_diff <= MESH_STATE_ATOL and av_rel <= MESH_AV_RTOL):
            fail(f"mesh {row['mesh']} disagrees with one device: {row}")
        rows.append(row)
    return rows


def main(argv=None) -> int:
    args = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args.add_argument("--four-gpus", action="store_true",
                      help="run only the 4-GPU mesh phase")
    args = args.parse_args(argv)

    devices = require_gpus(4 if args.four_gpus else 1)
    enable_compile_cache()
    if args.four_gpus:
        mesh_phase()
    else:
        # Deck inputs and outputs live in a scratch directory inside the
        # checkout, removed at the end.
        with tempfile.TemporaryDirectory(
            prefix=".chip_smoke_", dir=os.path.dirname(os.path.abspath(__file__))
        ) as workdir:
            for tag in CONFIGS:
                deck_phase(tag, workdir)
            deck_phase("1024x1024", workdir, precision="c16")
        hbm_phase()
    print(result_line(devices[0].device_kind, len(devices)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
