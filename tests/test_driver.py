"""Driver tests: the jitted fori_loop run vs the step-by-step oracle,
checkpoint/resume, and the golden av_vels prefix."""

import dataclasses

import numpy as np
import pytest

import oracle
from lbm_tpu.runtime.driver import run_simulation
from lbm_tpu.runtime.checkpoint import load_checkpoint, save_checkpoint


def run_oracle(params, obstacles, n):
    cells = oracle.initial_state(params)
    tot_cells = int((obstacles == 0).sum())
    av = []
    for _ in range(n):
        cells, tot_u = oracle.step(
            cells, obstacles, params.density, params.accel, params.omega
        )
        av.append(tot_u / tot_cells)
    return cells, np.array(av)


def test_run_matches_oracle(small_params, small_obstacles):
    import jax.numpy as jnp

    result = run_simulation(
        small_params, small_obstacles, backend="reference", dtype=jnp.float64
    )
    want_cells, want_av = run_oracle(small_params, small_obstacles, small_params.max_iters)
    np.testing.assert_allclose(result.av_vels, want_av, rtol=1e-9)
    np.testing.assert_allclose(result.cells, want_cells, rtol=1e-9)


def test_f32_run_close_to_f64_oracle(small_params, small_obstacles):
    result = run_simulation(small_params, small_obstacles, backend="reference")
    want_cells, want_av = run_oracle(small_params, small_obstacles, small_params.max_iters)
    np.testing.assert_allclose(result.av_vels, want_av, rtol=1e-4)


def test_golden_av_vels_prefix(params128, obstacles128):
    """First 200 steps of the 128x128 config against the golden av_vels series
    (full-run validation is the slow golden test)."""
    from lbm_tpu.utils.decks import load_gold

    p = dataclasses.replace(params128, max_iters=200)
    result = run_simulation(p, obstacles128, backend="reference")
    gold = load_gold("128x128")["av_vels"][:200]
    np.testing.assert_allclose(result.av_vels, gold, rtol=1e-3)


def test_checkpoint_roundtrip(tmp_path, small_params):
    cells = oracle.initial_state(small_params)
    av = np.arange(7, dtype=np.float64)
    path = tmp_path / "ckpt.npz"
    save_checkpoint(path, small_params, cells, av, 7)
    got_cells, got_av, step = load_checkpoint(path, small_params)
    np.testing.assert_array_equal(got_cells, cells)  # pure numpy roundtrip: exact
    np.testing.assert_array_equal(got_av, av)
    assert step == 7
    bad = dataclasses.replace(small_params, omega=1.5)
    with pytest.raises(ValueError):
        load_checkpoint(path, bad)


def test_resume_reproduces_uninterrupted_run(tmp_path, small_params, small_obstacles):
    import jax.numpy as jnp

    full = run_simulation(
        small_params, small_obstacles, backend="reference", dtype=jnp.float64
    )
    # Run with checkpointing every 7 steps, then resume from the midpoint file.
    path = tmp_path / "ckpt.npz"
    run_simulation(
        small_params,
        small_obstacles,
        backend="reference",
        dtype=jnp.float64,
        checkpoint_every=7,
        checkpoint_path=str(path),
    )
    cells, av, step = load_checkpoint(path, small_params)
    assert step == small_params.max_iters
    # Simulate a crash after step 7: run 7 steps, resume from there to the end.
    first7 = run_simulation(
        dataclasses.replace(small_params, max_iters=7),
        small_obstacles,
        backend="reference",
        dtype=jnp.float64,
    )
    resumed = run_simulation(
        small_params,
        small_obstacles,
        backend="reference",
        dtype=jnp.float64,
        initial_cells=first7.cells,
        start_step=7,
        av_vels_prefix=first7.av_vels,
    )
    np.testing.assert_allclose(resumed.av_vels, full.av_vels, rtol=1e-11)
    np.testing.assert_allclose(resumed.cells, full.cells, rtol=1e-11)


def test_reynolds_number(small_params, small_obstacles):
    result = run_simulation(small_params, small_obstacles, backend="reference")
    re = result.reynolds(small_params, small_obstacles)
    # viscosity = (2/omega - 1)/6 (d2q9-bgk.c:817)
    visc = (2.0 / small_params.omega - 1.0) / 6.0
    free = small_obstacles == 0
    cells = result.cells
    rho = cells.sum(axis=0)
    ux = (cells[1] + cells[5] + cells[8] - cells[3] - cells[6] - cells[7]) / rho
    uy = (cells[2] + cells[5] + cells[6] - cells[4] - cells[7] - cells[8]) / rho
    av = np.sqrt(ux**2 + uy**2)[free].sum() / free.sum()
    assert re == pytest.approx(av * small_params.reynolds_dim / visc, rel=1e-5)


def test_backend_auto_fallback_nonaligned():
    """Any grid shape runs the jnp step under ``auto``; a backend name that
    is not served errors instead of silently running something else."""
    from lbm_tpu.models.d2q9 import LBMParams
    from lbm_tpu.runtime.driver import select_step_fn

    p = LBMParams(nx=100, ny=100, max_iters=1, reynolds_dim=10,
                  density=0.1, accel=0.005, omega=1.85)
    fn, name = select_step_fn(p, "auto")
    assert name == "reference"
    with pytest.raises(ValueError):
        select_step_fn(p, "pallas")


def test_orbax_checkpoint_roundtrip(tmp_path, small_params):
    pytest.importorskip("orbax.checkpoint")
    from lbm_tpu.runtime.checkpoint import (
        load_checkpoint_orbax,
        save_checkpoint_orbax,
    )

    cells = oracle.initial_state(small_params)
    av = np.arange(5, dtype=np.float64)
    path = tmp_path / "orbax_ckpt"
    save_checkpoint_orbax(path, small_params, cells, av, 5)
    got_cells, got_av, step = load_checkpoint_orbax(path, small_params)
    np.testing.assert_array_equal(got_cells, cells)
    np.testing.assert_array_equal(got_av, av)
    assert step == 5
    bad = dataclasses.replace(small_params, density=0.2)
    with pytest.raises(ValueError):
        load_checkpoint_orbax(path, bad)


def test_compute_chunk_sizes_alignment():
    """Chunk boundaries land on every checkpoint multiple even when a
    smaller chunk_every stride is active, and an unaligned resume realigns
    at the next multiple."""
    from lbm_tpu.runtime.driver import compute_chunk_sizes

    def boundaries(start, sizes):
        out, s = [], start
        for n in sizes:
            s += n
            out.append(s)
        return out

    # checkpoint_every=100 with chunk_every=30: step 100 must be a boundary.
    sizes = compute_chunk_sizes(0, 150, checkpoint_every=100, chunk_every=30)
    b = boundaries(0, sizes)
    assert 100 in b and b[-1] == 150
    assert all(n > 0 for n in sizes)

    # Unaligned resume (start=37, every=25): next checkpoints at 50, 75, 100.
    sizes = compute_chunk_sizes(37, 100, checkpoint_every=25)
    assert boundaries(37, sizes) == [50, 75, 100]

    # No strides: one chunk.
    assert compute_chunk_sizes(5, 42) == [37]

    # chunk_every alone.
    assert compute_chunk_sizes(0, 10, chunk_every=4) == [4, 4, 2]


def test_f64_routes_to_reference(small_params):
    """auto + f64 runs the jnp step at f64 (never a silent downgrade), and
    a removed backend name errors."""
    import jax.numpy as jnp

    from lbm_tpu.ops.reference import lbm_step_reference
    from lbm_tpu.runtime.driver import select_step_fn

    fn, name = select_step_fn(small_params, "auto", jnp.float64)
    assert fn is lbm_step_reference and name == "reference"
    with pytest.raises(ValueError, match="unknown backend"):
        select_step_fn(small_params, "pallas", jnp.float64)


def test_upload_obstacles_bitpack_roundtrip():
    """upload_obstacles ships 1 bit/cell and must reproduce the
    blocked/unblocked semantics exactly — including nonzero values other
    than 1 and non-multiple-of-8 cell counts."""
    from lbm_tpu.runtime.driver import upload_obstacles

    rng = np.random.default_rng(7)
    for ny, nx in ((8, 8), (13, 24), (96, 200)):
        mask = (rng.random((ny, nx)) < 0.3).astype(np.int32) * 7
        got = np.asarray(upload_obstacles(mask))
        assert got.shape == (ny, nx) and got.dtype == np.int32
        np.testing.assert_array_equal(got, (mask != 0).astype(np.int32))


def test_fetch_final_false_skips_state(small_params, small_obstacles):
    """fetch_final=False returns cells=None with an identical av series
    (timing runs skip the device-to-host copy of the final state)."""
    full = run_simulation(small_params, small_obstacles, backend="reference")
    slim = run_simulation(
        small_params, small_obstacles, backend="reference", fetch_final=False
    )
    assert slim.cells is None
    np.testing.assert_array_equal(full.av_vels, slim.av_vels)
