"""Tests for device selection, diagnostics, geometry generators, viz."""

import numpy as np
import pytest

import oracle
from lbm_tpu.models.d2q9 import LBMParams
from lbm_tpu.runtime.device import format_device_list, select_device
from lbm_tpu.utils.diagnostics import NaNError, check_finite, debug_report, total_density
from lbm_tpu.utils.geometry import (
    box,
    box_with_vertical_wall,
    channel_with_divider,
    write_obstacle_file,
    write_params_file,
)


def test_select_device_default_and_env(monkeypatch):
    d0 = select_device(None)
    assert d0 is select_device(0)
    monkeypatch.setenv("LBM_DEVICE", "1")
    assert select_device(None).id == 1
    monkeypatch.setenv("LBM_DEVICE", "junk")
    with pytest.raises(ValueError):
        select_device(None)
    with pytest.raises(IndexError):
        select_device(99)


def test_format_device_list():
    text = format_device_list()
    assert "Available devices:" in text and "0:" in text


def test_total_density_and_debug_report(small_params):
    cells = oracle.initial_state(small_params)
    # Initial mass = density * nx * ny exactly (weights sum to 1).
    assert total_density(cells) == pytest.approx(
        small_params.density * small_params.nx * small_params.ny, rel=1e-9
    )
    report = debug_report(3, 1.5e-5, cells)
    assert report.startswith("==timestep: 3==")
    assert "av velocity: 1.500000000000E-05" in report


def test_check_finite():
    check_finite(np.array([1.0, 2.0]))
    with pytest.raises(NaNError, match="step 1"):
        check_finite(np.array([1.0, np.nan]))
    with pytest.raises(NaNError):
        check_finite(np.array([1.0]), np.array([np.inf]))


def _deck_mask_via_files(tag, tmp_path):
    """The deck's obstacle mask after a round trip through its files."""
    from lbm_tpu.io import read_obstacles, read_params
    from lbm_tpu.utils.decks import write_deck

    params_path, obstacles_path = write_deck(tag, tmp_path)
    return read_obstacles(obstacles_path, read_params(params_path))


def _gold_obstacles(tag):
    """Obstacle cells of the in-tree gold: pressure exactly density/3 there
    (d2q9-bgk.c:862-866), which no fluid cell of a flowing run holds."""
    from lbm_tpu.utils.decks import deck_params, load_gold

    return load_gold(tag)["pressure"] == deck_params(tag).density / 3.0


def test_geometry_box_matches_reference_128(tmp_path):
    mask = _deck_mask_via_files("128x128", tmp_path)
    np.testing.assert_array_equal(box(128, 128), mask)
    # The upstream geometry: a closed box, 4*128-4 wall cells (SURVEY.md §2.1).
    assert mask.sum() == 4 * 128 - 4
    assert (_gold_obstacles("128x128") >= (mask != 0)).all()


def test_geometry_channel_matches_reference_128x256(tmp_path):
    mask = _deck_mask_via_files("128x256", tmp_path)
    np.testing.assert_array_equal(channel_with_divider(128, 256), mask)
    assert mask[:, 0].all() and mask[:, -1].all() and mask[127, :].all()
    assert (_gold_obstacles("128x256") >= (mask != 0)).all()


def test_geometry_wall_matches_reference_1024(tmp_path):
    mask = _deck_mask_via_files("1024x1024", tmp_path)
    np.testing.assert_array_equal(box_with_vertical_wall(1024, 1024, wall_col=341), mask)
    assert mask[:, 341].all()
    assert (_gold_obstacles("1024x1024") >= (mask != 0)).all()


def test_obstacle_file_roundtrip(tmp_path):
    from lbm_tpu.io import read_obstacles

    p = LBMParams(nx=16, ny=8, max_iters=1, reynolds_dim=10, density=0.1, accel=0.005, omega=1.85)
    mask = box(16, 8)
    f = tmp_path / "obs.dat"
    write_obstacle_file(f, mask)
    np.testing.assert_array_equal(read_obstacles(f, p), mask)


def test_params_file_roundtrip(tmp_path):
    from lbm_tpu.io import read_params

    f = tmp_path / "x.params"
    write_params_file(f, 64, 32, 100, 10, 0.1, 0.005, 1.85)
    p = read_params(f)
    assert (p.nx, p.ny, p.max_iters) == (64, 32, 100)
    assert (p.density, p.accel, p.omega) == (0.1, 0.005, 1.85)


def test_viz_roundtrip(tmp_path, small_params, small_obstacles):
    from lbm_tpu.io.files import write_final_state
    from lbm_tpu.utils.viz import load_speed_field, render_png

    cells = oracle.initial_state(small_params)
    fs = tmp_path / "final_state.dat"
    write_final_state(fs, small_params, cells, small_obstacles)
    field = load_speed_field(fs)
    assert field.shape == (small_params.ny, small_params.nx)
    out = tmp_path / "final_state.png"
    render_png(field, out)
    assert out.exists() or out.with_suffix(".ppm").exists()
