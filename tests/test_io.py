"""IO format parity tests: parsers and byte-exact writers (SURVEY.md §7.1)."""

import numpy as np
import pytest

import oracle
from lbm_tpu.io import read_obstacles, read_params, write_av_vels, write_final_state
from lbm_tpu.io.files import InputError
from lbm_tpu.models.d2q9 import LBMParams


def test_read_params_reference_files(tmp_path):
    from lbm_tpu.utils.decks import write_deck

    p = read_params(write_deck("128x128", tmp_path)[0])
    assert (p.nx, p.ny, p.max_iters, p.reynolds_dim) == (128, 128, 40000, 10)
    assert (p.density, p.accel, p.omega) == (0.1, 0.005, 1.85)
    p = read_params(write_deck("1024x1024", tmp_path)[0])
    assert (p.nx, p.ny, p.max_iters) == (1024, 1024, 20000)
    assert p.accel == 0.01


def test_read_params_errors(tmp_path):
    f = tmp_path / "bad.params"
    f.write_text("128 128 100\n")
    with pytest.raises(InputError):
        read_params(f)
    f.write_text("a b c d e f g\n")
    with pytest.raises(InputError):
        read_params(f)


def test_read_obstacles_reference_file(tmp_path):
    from lbm_tpu.utils.decks import write_deck

    params_path, obstacles_path = write_deck("128x128", tmp_path)
    p = read_params(params_path)
    mask = read_obstacles(obstacles_path, p)
    # The 128x128 geometry is a closed box: full walls on all four edges.
    assert mask.shape == (128, 128)
    assert mask[0, :].all() and mask[-1, :].all()
    assert mask[:, 0].all() and mask[:, -1].all()
    assert mask.sum() == 4 * 128 - 4


def test_read_obstacles_validation(tmp_path):
    p = LBMParams(nx=4, ny=4, max_iters=1, reynolds_dim=1, density=0.1, accel=0.005, omega=1.85)
    f = tmp_path / "obs.dat"
    f.write_text("4 0 1\n")  # x out of range (d2q9-bgk.c:615-618)
    with pytest.raises(InputError):
        read_obstacles(f, p)
    f.write_text("0 0 2\n")  # blocked != 1 (d2q9-bgk.c:624-625)
    with pytest.raises(InputError):
        read_obstacles(f, p)
    f.write_text("1 1 1\n1 1 1\n")  # duplicates tolerated (d2q9-bgk.c:627)
    mask = read_obstacles(f, p)
    assert mask[1, 1] == 1 and mask.sum() == 1


def test_av_vels_format(tmp_path):
    path = tmp_path / "av_vels.dat"
    write_av_vels(path, np.array([1.094269153342e-05, 2.5e-1]))
    lines = path.read_text().splitlines()
    # "%d:\t%.12E\n" (d2q9-bgk.c:915)
    assert lines[0] == "0:\t1.094269153342E-05"
    assert lines[1] == "1:\t2.500000000000E-01"


def test_final_state_format(tmp_path, small_params, small_obstacles):
    path = tmp_path / "final_state.dat"
    cells = oracle.initial_state(small_params)
    write_final_state(path, small_params, cells, small_obstacles)
    lines = path.read_text().splitlines()
    assert len(lines) == small_params.nx * small_params.ny
    # Obstacle (0,0): u=0, pressure=density/3 (d2q9-bgk.c:862-866).
    assert lines[0] == (
        "0 0 0.000000000000E+00 0.000000000000E+00 0.000000000000E+00 "
        "3.333333333333E-02 1"
    )
    # Row-major: line index = y*nx + x, columns are "x y ..." (d2q9-bgk.c:900).
    x, y = 3, 1
    fields = lines[y * small_params.nx + x].split()
    assert fields[0] == "3" and fields[1] == "1"
    # At-rest fluid cell: zero velocity, pressure = rho/3.
    assert fields[2] == "0.000000000000E+00"
    assert float(fields[5]) == pytest.approx(small_params.density / 3, rel=1e-12)


def test_final_state_golden_first_lines(tmp_path, params128, obstacles128):
    """The golden 128x128 final_state's obstacle lines are reproduced exactly
    by the writer given any state (obstacle output depends only on params):
    the upstream gold's first line, and the in-tree gold's pressure there."""
    from lbm_tpu.utils.decks import write_gold_files

    path = tmp_path / "final_state.dat"
    cells = oracle.initial_state(params128)
    write_final_state(path, params128, cells, obstacles128)
    with open(path) as f:
        ours = f.readline().rstrip("\n")
    assert ours == (
        "0 0 0.000000000000E+00 0.000000000000E+00 0.000000000000E+00 "
        "3.333333333333E-02 1"
    )
    _, gold_fs = write_gold_files("128x128", tmp_path)
    with open(gold_fs) as f:
        gold = f.readline().split()
    assert gold[:2] == ours.split()[:2] and gold[5] == ours.split()[5]


def test_checker_mirror_pass_and_fail(tmp_path):
    from lbm_tpu.utils.checker import check_files

    ref_av = tmp_path / "ref_av.dat"
    sim_av = tmp_path / "sim_av.dat"
    ref_fs = tmp_path / "ref_fs.dat"
    sim_fs = tmp_path / "sim_fs.dat"
    write_av_vels(ref_av, np.array([1.0, 2.0]))
    write_av_vels(sim_av, np.array([1.0, 2.005]))  # 0.25% off
    line = "%d %d 0 0 0 %.12E 0\n"
    ref_fs.write_text(line % (0, 0, 0.1))
    sim_fs.write_text(line % (0, 0, 0.1001))
    res = check_files(sim_av, sim_fs, ref_av, ref_fs, tolerance=1.0)
    assert res.passed
    # Tighter tolerance fails; percent diff is relative to SIM (check.py:86-87).
    res = check_files(sim_av, sim_fs, ref_av, ref_fs, tolerance=0.01)
    assert not res.passed
    assert res.av_vels.max_diff_pcnt == pytest.approx(100 * (2.0 - 2.005) / 2.005)
