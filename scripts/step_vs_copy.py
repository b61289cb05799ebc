#!/usr/bin/env python
"""How far the XLA-compiled jnp step sits from the one-pass floor, on a GPU.

For each grid side (default 128, 1024 and 8192, f32, the box geometry) this times,
in one process:

- the driver's run loop (``runtime/driver._run_loop``): device time per step;
- a loop that reads and writes the whole ``(9, ny, nx)`` state once per
  iteration (``x * s`` with a runtime ``s``): the one-pass floor any step
  kernel is bounded by, 72 B per cell per iteration in f32;

and traces a few steps with ``jax.profiler`` to count the kernels XLA
launches per step and their device time. XLA's own estimate of the bytes a
single step accesses (``cost_analysis``) gives the full-state passes.

    python scripts/step_vs_copy.py [side ...] [--out DIR]

Prints one JSON line per grid; ``--out`` (default ``chiprun_out/step_vs_copy``)
receives the traces and a summary JSON.
"""

import glob
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _timed(fn, *args, reps=3):
    """Best-of-``reps`` wall time of ``fn(*args)`` ending in block_until_ready."""
    import jax

    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def _trace_kernels(trace_dir, steps):
    """Kernel events on the GPU planes of the newest trace in ``trace_dir``:
    per line, the count per step and the device time per step."""
    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    lines = {}
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            events = list(line.events)
            names = {}
            for e in events:
                names[e.name] = names.get(e.name, 0) + 1
            if not events:
                continue
            span = (max(e.start_ns + e.duration_ns for e in events)
                    - min(e.start_ns for e in events))
            busy = sum(e.duration_ns for e in events)
            lines[f"{plane.name}/{line.name}"] = {
                "events_per_step": len(events) / steps,
                "device_us_per_step": busy / steps / 1e3,
                "span_us_per_step": span / steps / 1e3,
                "idle_share": 1.0 - busy / span if span else None,
                "top": sorted(names.items(), key=lambda kv: -kv[1])[:12],
            }
    return lines


def measure(side, out_dir):
    import jax
    import jax.numpy as jnp

    from lbm_tpu.models.d2q9 import D2Q9, LBMParams
    from lbm_tpu.ops.reference import lbm_step_reference
    from lbm_tpu.runtime.driver import _run_loop, inv_tot_cells_for, upload_obstacles
    from lbm_tpu.utils.geometry import box

    params = LBMParams(nx=side, ny=side, max_iters=1, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    obstacles = box(side, side)
    obs = upload_obstacles(obstacles)
    inv = inv_tot_cells_for(obstacles, jnp.float32)
    steps = 2000 if side <= 256 else 200 if side <= 2048 else 50
    consts = dict(density=0.1, accel=0.005, omega=1.85,
                  step_fn=lbm_step_reference)

    def fresh():
        return jax.device_put(D2Q9.initial_state(params, jnp.float32))

    loop = _run_loop.lower(fresh(), obs, inv, n_iters=steps, **consts).compile()
    step_s = min(_timed(lambda: loop(fresh(), obs, inv), reps=1) for _ in range(3))

    @jax.jit
    def copy_loop(x, s):
        return jax.lax.fori_loop(0, steps, lambda i, x: x * s, x)

    x = fresh()
    s = jnp.float32(1.0)
    copy_s = _timed(copy_loop, x, s)

    single = jax.jit(lambda c, o: lbm_step_reference(c, o, 0.1, 0.005, 1.85))
    cost = single.lower(x, obs).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    state_bytes = 9 * side * side * 4

    trace_steps = 100 if side <= 256 else 5
    tloop = _run_loop.lower(fresh(), obs, inv, n_iters=trace_steps, **consts).compile()
    jax.block_until_ready(tloop(fresh(), obs, inv))
    trace_dir = os.path.join(out_dir, f"trace_{side}")
    x_t = fresh()
    with jax.profiler.trace(trace_dir):
        jax.block_until_ready(tloop(x_t, obs, inv))
    kernels = _trace_kernels(trace_dir, trace_steps)

    row = {
        "grid": f"{side}x{side}", "dtype": "float32", "steps_timed": steps,
        "device": jax.devices()[0].device_kind,
        "step_us": step_s / steps * 1e6,
        "copy_us": copy_s / steps * 1e6,
        "step_over_copy": step_s / copy_s,
        "copy_GBps": 2 * state_bytes * steps / copy_s / 1e9,
        "step_effective_GBps": 2 * state_bytes * steps / step_s / 1e9,
        "hlo_bytes_per_step": cost.get("bytes accessed"),
        "hlo_state_passes": (cost.get("bytes accessed") or 0) / state_bytes,
        "trace_lines": kernels,
    }
    return row


def main(argv):
    out_dir = "chiprun_out/step_vs_copy"
    if "--out" in argv:
        i = argv.index("--out")
        out_dir = argv[i + 1]
        del argv[i : i + 2]
    sides = [int(a) for a in argv] or [128, 1024, 8192]

    import jax

    from lbm_tpu.runtime.compile_cache import enable_compile_cache
    from lbm_tpu.runtime.device import gpu_name_and_power_limit

    if jax.devices()[0].platform != "gpu":
        print("step_vs_copy.py: no GPU", file=sys.stderr)
        return 1
    enable_compile_cache()
    os.makedirs(out_dir, exist_ok=True)
    power = gpu_name_and_power_limit()
    print(f"# nvidia-smi name, power.limit: {power}")
    rows = []
    for side in sides:
        row = measure(side, out_dir)
        row["nvidia_smi"] = power
        rows.append(row)
        brief = {k: v for k, v in row.items() if k != "trace_lines"}
        print(json.dumps(brief))
        for name, line in row["trace_lines"].items():
            print(f"#   {name}: {line['events_per_step']:.1f} events/step, "
                  f"{line['device_us_per_step']:.2f} us/step busy of "
                  f"{line['span_us_per_step']:.2f} (idle {line['idle_share']:.3f}), "
                  f"top {line['top'][:6]}")
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
