"""Golden-file end-to-end validation (the reference's acceptance gate,
SURVEY.md §4) — ALL FOUR reference decks, full iteration counts, on the CPU.
The full runs are marked slow; the default suite covers the golds themselves
and short prefixes. ``chip_smoke.py`` runs the full decks on the GPU.

Gold sources: ``tests/golden/<tag>.golden.npz`` — f64 reruns of each deck
(``scripts/make_golden.py``) holding the av_vels series, the final pressure
field and the final Reynolds number. The 256x256 and 1024x1024 golds matched
the upstream av_vels golds to ~3e-10 % when they were made; the 128x128 and
128x256 golds reproduce the upstream Reynolds numbers (BASELINE.md:15-16).
"""

import dataclasses

import numpy as np
import pytest

from lbm_tpu.io import write_av_vels, write_final_state
from lbm_tpu.runtime.driver import run_simulation
from lbm_tpu.utils.checker import check_files
from lbm_tpu.utils.decks import (
    CONFIGS,
    deck_obstacles,
    deck_params,
    load_gold,
    write_gold_files,
)

# Upstream Reynolds numbers (BASELINE.md, from the reference README.md:78-98).
UPSTREAM_REYNOLDS = {
    "128x128": 9.763598020526,
    "128x256": 3.718483826704e01,
    "256x256": 1.007703420252e01,
}


def run_config(tag, tmp_path):
    params = deck_params(tag)
    obstacles = deck_obstacles(tag)
    result = run_simulation(params, obstacles, backend="reference")
    av = tmp_path / "av_vels.dat"
    fs = tmp_path / "final_state.dat"
    write_av_vels(av, result.av_vels)
    write_final_state(fs, params, result.cells, obstacles)
    return params, obstacles, result, av, fs


def assert_gate(check, tag):
    assert check.passed, (
        f"{tag}: av max {check.av_vels.max_diff_pcnt}% "
        f"fs max {check.final_state.max_diff_pcnt}%"
    )
    # f32 drift is far inside the 1% gate in practice (~0.07-0.11%).
    assert abs(check.av_vels.max_diff_pcnt) < 0.5


def gate_full_run(tag, tmp_path):
    params, obstacles, result, av, fs = run_config(tag, tmp_path)
    check = check_files(av, fs, *write_gold_files(tag, tmp_path), tolerance=1.0)
    assert_gate(check, tag)
    return params, obstacles, result


@pytest.mark.slow
def test_golden_128x128_full_run(tmp_path):
    params, obstacles, result = gate_full_run("128x128", tmp_path)
    # Reynolds number close to the reference's published value (README.md:78).
    re = result.reynolds(params, obstacles)
    assert re == pytest.approx(UPSTREAM_REYNOLDS["128x128"], rel=2e-3)


@pytest.mark.slow
def test_golden_128x256_full_run(tmp_path):
    """The deck the reference's own GPU build cannot run (its kernel
    decomposition is broken for non-square grids, kernels.cl:66-69)."""
    params, obstacles, result = gate_full_run("128x256", tmp_path)
    re = result.reynolds(params, obstacles)
    assert re == pytest.approx(UPSTREAM_REYNOLDS["128x256"], rel=2e-3)


@pytest.mark.slow
def test_golden_256x256_full_run(tmp_path):
    params, obstacles, result = gate_full_run("256x256", tmp_path)
    re = result.reynolds(params, obstacles)
    assert re == pytest.approx(UPSTREAM_REYNOLDS["256x256"], rel=2e-3)


@pytest.mark.slow
def test_golden_1024x1024_full_run(tmp_path):
    """The largest deck (20k iters; ~20 min on CPU)."""
    gate_full_run("1024x1024", tmp_path)


def test_standin_golds_provenance():
    """Each committed gold carries its provenance: the two large decks record
    that their f64 rerun matched the upstream av_vels gold, the two small
    ones reproduce the upstream Reynolds number to 1e-9."""
    for tag in CONFIGS:
        data = load_gold(tag)
        params = deck_params(tag)
        assert data["pressure"].shape == (params.ny, params.nx)
        assert data["pressure"].dtype == np.float64
        # av_vels series kept too (enables drift studies).
        assert data["av_vels"].shape == (params.max_iters,)
        if "max_av_diff_pct_vs_upstream" in data.files:
            assert float(data["max_av_diff_pct_vs_upstream"]) < 1e-6
        else:
            assert float(data["reynolds"]) == pytest.approx(
                UPSTREAM_REYNOLDS[tag], rel=1e-9
            )


@pytest.mark.parametrize("tag", list(CONFIGS))
def test_gold_files_materialise_for_checker(tag, tmp_path):
    """The gold, written in the reference formats, passes the checker
    against itself and has one line per step and per cell."""
    av, fs = write_gold_files(tag, tmp_path)
    params = deck_params(tag)
    check = check_files(av, fs, av, fs, tolerance=1.0)
    assert check.passed and check.av_vels.max_diff_pcnt == 0.0
    with open(av) as f:
        assert sum(1 for _ in f) == params.max_iters
    with open(fs) as f:
        first = f.readline().split()
    assert first[:2] == ["0", "0"]
    assert float(first[5]) == pytest.approx(params.density / 3.0, rel=1e-12)


@pytest.mark.parametrize("tag", list(CONFIGS))
def test_gold_prefix_f32(tag):
    """The first 100 steps of each deck in f32 track its f64 gold."""
    p = dataclasses.replace(deck_params(tag), max_iters=100)
    result = run_simulation(p, deck_obstacles(tag))
    gold = load_gold(tag)["av_vels"][:100]
    np.testing.assert_allclose(result.av_vels, gold, rtol=1e-3)
