#!/usr/bin/env python
"""Scaling benchmark: the 8192x8192 lattice over a 1-D row mesh.

Default (real devices): runs the sharded jnp step over every mesh size in
1, 2, 4, 8 that the device count allows and prints one JSON line per mesh
size:

    {"metric": "mlups_8192_mesh1", "value": ..., "unit": "MLUPS", ...}

``--out FILE`` also writes the artifact: per-mesh MLUPS, halo bytes per
shard per step, and efficiency against the mesh=1 run.

``--cpu-mesh`` checks the sweep end to end on 8 virtual CPU devices at a
small size. Its numbers are CPU numbers: they check the protocol, not the
speed of any device.

    python bench_scaling.py [iters] [--out FILE] [--cpu-mesh]
"""

import json
import sys
import time

N_SIDE = 8192
BASELINE_MLUPS = 128 * 128 * 40000 / 4.5 / 1e6  # reference's best ~146


def _mesh_run(params, obstacles, n):
    from lbm_tpu.parallel.sharded import run_simulation_sharded
    from lbm_tpu.runtime.driver import run_simulation

    if n == 1:
        run_simulation(params, obstacles, fetch_final=False)
        return run_simulation(params, obstacles, fetch_final=False)
    run_simulation_sharded(params, obstacles, n_devices=n)
    return run_simulation_sharded(params, obstacles, n_devices=n)


def main() -> int:
    cpu_mesh = "--cpu-mesh" in sys.argv
    out_path = None
    argv = [a for a in sys.argv[1:] if a != "--cpu-mesh"]
    if "--out" in argv:
        i = argv.index("--out")
        out_path = argv[i + 1]
        del argv[i : i + 2]

    import jax

    if cpu_mesh:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 8)
        side, default_iters = 256, 64
    else:
        side, default_iters = N_SIDE, 200

    from lbm_tpu.models.d2q9 import LBMParams
    from lbm_tpu.runtime.compile_cache import enable_compile_cache
    from lbm_tpu.runtime.device import gpu_name_and_power_limit
    from lbm_tpu.utils.geometry import box

    enable_compile_cache()
    iters = int(argv[0]) if argv else default_iters
    params = LBMParams(
        nx=side, ny=side, max_iters=iters, reynolds_dim=10,
        density=0.1, accel=0.005, omega=1.85,
    )
    obstacles = box(side, side)

    dev = jax.devices()[0]
    n_avail = len(jax.devices())
    meshes = [n for n in (1, 2, 4, 8) if n <= n_avail]
    artifact = {
        "meta": {
            "side": side, "iters": iters, "cpu_mesh": cpu_mesh,
            "device": f"{dev.device_kind} ({dev.platform}) x {n_avail}",
            "power": None if cpu_mesh else gpu_name_and_power_limit(),
            "time": time.strftime("%Y-%m-%d %H:%M:%S"),
        },
        "meshes": {},
    }
    print(f"# {artifact['meta']['device']}; {artifact['meta']['power']}",
          file=sys.stderr)
    base_mlups = None
    for n in meshes:
        res = _mesh_run(params, obstacles, n)
        mlups = res.mlups(params)
        if base_mlups is None:
            base_mlups = mlups
        # Per step each shard sends one row of 3 planes in each y direction.
        halo_bytes_step = 2 * 3 * side * 4 if n > 1 else 0
        artifact["meshes"][str(n)] = {
            "mlups": mlups,
            "loop_s": res.elapsed,
            "halo_bytes_per_shard_step": halo_bytes_step,
            "efficiency_vs_mesh1": mlups / (base_mlups * n),
        }
        print(json.dumps({
            "metric": f"mlups_{side}_mesh{n}",
            "value": round(mlups, 1),
            "unit": "MLUPS",
            "vs_baseline": round(mlups / BASELINE_MLUPS, 2),
        }))
        print(f"# mesh={n}: loop {res.elapsed:.4f}s for {iters} iters",
              file=sys.stderr)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(artifact, f, indent=1)
        print(f"# artifact -> {out_path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
