#!/usr/bin/env python
"""Benchmark: one-GPU throughput on the reference's largest deck.

Runs the 1024x1024 deck (built in-process from ``lbm_tpu.utils.decks``) on
the first GPU, compiles ahead of time, warms up once with the same iteration
count, times three runs of the official 20000-iteration loop and prints ONE
JSON line on stdout (the best of the three):

    {"metric": "mlups_1024x1024", "value": ..., "unit": "MLUPS", "vs_baseline": ...}

The device kind, device count and the card's name and power limit go to
stderr. It fails when JAX finds no GPU: a CPU number is not a device number.

vs_baseline is relative to the reference's best published number: its final
OpenCL version runs 128x128 x 40k iters in 4.5 s on a BCP3 GPU node
(`OpenCL tests.numbers` row 12) = 145.6 MLUPS.

    python bench.py [iters]
"""

import dataclasses
import json
import sys

BASELINE_MLUPS = 128 * 128 * 40000 / 4.5 / 1e6  # reference's best: ~145.6


def main() -> int:
    import jax

    from lbm_tpu.runtime.compile_cache import enable_compile_cache
    from lbm_tpu.runtime.device import gpu_name_and_power_limit
    from lbm_tpu.runtime.driver import run_simulation
    from lbm_tpu.utils.decks import deck_obstacles, deck_params

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: no GPU (JAX found {dev.platform!r}); refusing to "
              "report a non-GPU number", file=sys.stderr)
        return 1
    print(f"# {dev.device_kind} x {len(jax.devices())}; "
          f"nvidia-smi: {gpu_name_and_power_limit()}", file=sys.stderr)
    enable_compile_cache()

    params = deck_params("1024x1024")
    obstacles = deck_obstacles("1024x1024")
    iters = int(sys.argv[1]) if len(sys.argv) > 1 else params.max_iters
    p = dataclasses.replace(params, max_iters=iters)

    run_simulation(p, obstacles, fetch_final=False)  # warmup, same program
    passes = [run_simulation(p, obstacles, fetch_final=False) for _ in range(3)]
    result = min(passes, key=lambda r: r.elapsed)
    mlups = result.mlups(p)
    print(
        json.dumps(
            {
                "metric": "mlups_1024x1024",
                "value": round(mlups, 1),
                "unit": "MLUPS",
                "vs_baseline": round(mlups / BASELINE_MLUPS, 2),
            }
        )
    )
    print(
        f"# {iters} iters, best loop {result.elapsed:.4f}s of "
        f"{[round(r.elapsed, 4) for r in passes]}",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
