"""End-to-end CLI tests (in-process main(), CPU backend)."""

import os

import numpy as np
import pytest

from lbm_tpu.cli import main
from lbm_tpu.utils.geometry import write_obstacle_file, write_params_file, box


@pytest.fixture
def tiny_inputs(tmp_path):
    params = tmp_path / "tiny.params"
    obstacles = tmp_path / "tiny_obs.dat"
    write_params_file(params, 16, 16, 8, 10, 0.1, 0.005, 1.85)
    write_obstacle_file(obstacles, box(16, 16))
    return str(params), str(obstacles)


def test_cli_end_to_end(tiny_inputs, tmp_path, capsys):
    params, obstacles = tiny_inputs
    out = tmp_path / "out"
    rc = main([params, obstacles, "--backend", "reference", "--out-dir", str(out)])
    assert rc == 0
    captured = capsys.readouterr().out
    # The reference's stdout contract (d2q9-bgk.c:283-287).
    assert "==done==" in captured
    assert "Reynolds number:\t\t" in captured
    assert "Elapsed time:\t\t\t" in captured
    av = (out / "av_vels.dat").read_text().splitlines()
    assert len(av) == 8 and av[0].startswith("0:\t")
    fs = (out / "final_state.dat").read_text().splitlines()
    assert len(fs) == 16 * 16


def test_cli_bad_inputs(tmp_path, capsys):
    assert main([str(tmp_path / "none.params"), "x"]) == 1
    assert "lbm_tpu: error:" in capsys.readouterr().err


def test_cli_list_devices(capsys):
    assert main(["--list-devices", "x", "y"]) == 0
    assert "Available devices:" in capsys.readouterr().out


def test_cli_debug_mode(tiny_inputs, tmp_path, capsys):
    params, obstacles = tiny_inputs
    rc = main(
        [params, obstacles, "--backend", "reference", "--out-dir", str(tmp_path / "o"),
         "--debug", "--check-nan"]
    )
    assert rc == 0
    out = capsys.readouterr().out
    # Per-step DEBUG report (d2q9-bgk.c:229-233).
    assert "==timestep: 0==" in out and "==timestep: 7==" in out
    assert "tot density:" in out


def test_cli_checkpoint_resume(tiny_inputs, tmp_path):
    params, obstacles = tiny_inputs
    out1 = tmp_path / "full"
    assert main([params, obstacles, "--backend", "reference", "--out-dir", str(out1)]) == 0
    out2 = tmp_path / "ck"
    ckpt = str(tmp_path / "ck.npz")
    assert (
        main(
            [params, obstacles, "--backend", "reference", "--out-dir", str(out2),
             "--checkpoint-every", "3", "--checkpoint-path", ckpt]
        )
        == 0
    )
    assert os.path.exists(ckpt)
    av1 = np.loadtxt(out1 / "av_vels.dat", usecols=[1])
    av2 = np.loadtxt(out2 / "av_vels.dat", usecols=[1])
    np.testing.assert_allclose(av1, av2, rtol=1e-6)
    # Resume from the final checkpoint is rejected (nothing left to run)…
    # resume from a mid-run snapshot continues to the same answer: simulate by
    # truncating: rerun with checkpointing to step 3 only is covered in
    # test_driver; here just confirm --resume with a complete checkpoint errors
    # cleanly.
    rc = main(
        [params, obstacles, "--backend", "reference", "--out-dir", str(out2),
         "--resume", "--checkpoint-path", ckpt]
    )
    assert rc == 1


def test_cli_mesh_sharded(tiny_inputs, tmp_path):
    params, obstacles = tiny_inputs
    out_s = tmp_path / "sharded"
    out_1 = tmp_path / "single"
    assert main([params, obstacles, "--backend", "reference", "--out-dir", str(out_1)]) == 0
    assert main([params, obstacles, "--mesh", "2", "--backend", "reference",
                 "--out-dir", str(out_s)]) == 0
    av1 = np.loadtxt(out_1 / "av_vels.dat", usecols=[1], ndmin=1)
    av2 = np.loadtxt(out_s / "av_vels.dat", usecols=[1], ndmin=1)
    np.testing.assert_allclose(av1, av2, rtol=1e-5)


def test_cli_profile_dir(tiny_inputs, tmp_path):
    params, obstacles = tiny_inputs
    prof = tmp_path / "trace"
    rc = main([params, obstacles, "--backend", "reference",
               "--out-dir", str(tmp_path / "o"), "--profile-dir", str(prof)])
    assert rc == 0
    assert prof.exists() and any(prof.rglob("*"))  # trace files written


def test_cli_mesh_2d(tiny_inputs, tmp_path):
    params, obstacles = tiny_inputs
    out = tmp_path / "m2d"
    assert main([params, obstacles, "--mesh", "2x2", "--out-dir", str(out)]) == 0
    assert (out / "av_vels.dat").exists()
    assert main([params, obstacles, "--mesh", "bogus", "--out-dir", str(out)]) == 1


def test_cli_stats_json(tiny_inputs, tmp_path):
    import json

    params, obstacles = tiny_inputs
    stats = tmp_path / "stats.json"
    rc = main([params, obstacles, "--backend", "reference",
               "--out-dir", str(tmp_path / "o"), "--stats-json", str(stats)])
    assert rc == 0
    data = json.loads(stats.read_text())
    assert data["nx"] == 16 and data["max_iters"] == 8
    assert data["mlups"] > 0 and "reynolds" in data


def test_cli_mesh_resume_continues(tiny_inputs, tmp_path):
    """--mesh + --resume continues a checkpointed sharded run from where it
    stopped (these flags used to be silently dropped)."""
    params, obstacles = tiny_inputs
    out_full = tmp_path / "full"
    assert main([params, obstacles, "--backend", "reference",
                 "--out-dir", str(out_full)]) == 0

    # Produce a mid-run checkpoint: run with --checkpoint-every, then rewind
    # the saved snapshot to step 3 by re-saving a truncated prefix.
    out_m = tmp_path / "mesh"
    ckpt = str(tmp_path / "mesh_ck.npz")
    assert main([params, obstacles, "--mesh", "2", "--backend", "reference",
                 "--out-dir", str(out_m), "--checkpoint-every", "3",
                 "--checkpoint-path", ckpt]) == 0

    import numpy as np

    from lbm_tpu.io import read_params
    from lbm_tpu.runtime.checkpoint import load_checkpoint, save_checkpoint

    p = read_params(params)
    data = np.load(ckpt)
    assert int(data["step"]) == p.max_iters  # checkpoints were written at all

    # Build a step-3 checkpoint from a fresh 3-step run, then resume on the
    # mesh and compare the full series to the uninterrupted single-device run.
    from lbm_tpu.io import read_obstacles
    from lbm_tpu.runtime.driver import run_simulation
    import dataclasses

    obs = read_obstacles(obstacles, p)
    p3 = dataclasses.replace(p, max_iters=3)
    r3 = run_simulation(p3, obs, backend="reference")
    save_checkpoint(ckpt, p, r3.cells, r3.av_vels, 3)

    out_r = tmp_path / "resumed"
    assert main([params, obstacles, "--mesh", "2", "--backend", "reference",
                 "--out-dir", str(out_r), "--resume",
                 "--checkpoint-path", ckpt]) == 0
    av_full = np.loadtxt(out_full / "av_vels.dat", usecols=[1], ndmin=1)
    av_res = np.loadtxt(out_r / "av_vels.dat", usecols=[1], ndmin=1)
    assert len(av_res) == p.max_iters
    np.testing.assert_allclose(av_full, av_res, rtol=1e-5)


def test_cli_mesh_rejects_debug(tiny_inputs, tmp_path, capsys):
    params, obstacles = tiny_inputs
    rc = main([params, obstacles, "--mesh", "2", "--debug",
               "--out-dir", str(tmp_path / "o")])
    assert rc == 1
    assert "--debug" in capsys.readouterr().err


def test_cli_mesh2d_checkpoint_resume(tiny_inputs, tmp_path):
    """Checkpoint + resume on a 2-D mesh matches the uninterrupted
    single-device run (2-D parity with the 1-D path)."""
    import dataclasses

    import numpy as np

    from lbm_tpu.io import read_obstacles, read_params
    from lbm_tpu.runtime.checkpoint import save_checkpoint
    from lbm_tpu.runtime.driver import run_simulation

    params, obstacles = tiny_inputs
    out_full = tmp_path / "full"
    assert main([params, obstacles, "--backend", "reference",
                 "--out-dir", str(out_full)]) == 0

    # Checkpoints are written while running on the 2-D mesh...
    ckpt = str(tmp_path / "m2d_ck.npz")
    assert main([params, obstacles, "--mesh", "2x2", "--backend", "reference",
                 "--out-dir", str(tmp_path / "m2d"), "--checkpoint-every", "3",
                 "--checkpoint-path", ckpt]) == 0
    p = read_params(params)
    assert int(np.load(ckpt)["step"]) == p.max_iters

    # ...and a mid-run snapshot resumes on the 2-D mesh to the same series.
    obs = read_obstacles(obstacles, p)
    r3 = run_simulation(dataclasses.replace(p, max_iters=3), obs,
                        backend="reference")
    save_checkpoint(ckpt, p, r3.cells, r3.av_vels, 3)
    out_r = tmp_path / "resumed2d"
    assert main([params, obstacles, "--mesh", "2x2", "--backend", "reference",
                 "--out-dir", str(out_r), "--resume",
                 "--checkpoint-path", ckpt]) == 0
    av_full = np.loadtxt(out_full / "av_vels.dat", usecols=[1], ndmin=1)
    av_res = np.loadtxt(out_r / "av_vels.dat", usecols=[1], ndmin=1)
    assert len(av_res) == p.max_iters
    np.testing.assert_allclose(av_full, av_res, rtol=1e-5)


def test_cli_orbax_checkpoint_roundtrip(tiny_inputs, tmp_path):
    """--checkpoint-format orbax writes an orbax directory and --resume
    reads it back to the same answer as an uninterrupted run."""
    pytest.importorskip("orbax.checkpoint")
    params, obstacles = tiny_inputs
    out_full = tmp_path / "full"
    assert main([params, obstacles, "--backend", "reference",
                 "--out-dir", str(out_full)]) == 0

    import dataclasses

    import numpy as np

    from lbm_tpu.io import read_obstacles, read_params
    from lbm_tpu.runtime.checkpoint import save_checkpoint_orbax
    from lbm_tpu.runtime.driver import run_simulation

    p = read_params(params)
    obs = read_obstacles(obstacles, p)
    ckpt = str(tmp_path / "ck.orbax")
    r3 = run_simulation(dataclasses.replace(p, max_iters=3), obs, backend="reference")
    save_checkpoint_orbax(ckpt, p, r3.cells, r3.av_vels, 3)

    out_r = tmp_path / "resumed"
    assert main([params, obstacles, "--backend", "reference",
                 "--out-dir", str(out_r), "--resume",
                 "--checkpoint-format", "orbax",
                 "--checkpoint-path", ckpt]) == 0
    av_full = np.loadtxt(out_full / "av_vels.dat", usecols=[1], ndmin=1)
    av_res = np.loadtxt(out_r / "av_vels.dat", usecols=[1], ndmin=1)
    np.testing.assert_allclose(av_full, av_res, rtol=1e-6)


def test_cli_orbax_checkpoint_written(tiny_inputs, tmp_path):
    pytest.importorskip("orbax.checkpoint")
    params, obstacles = tiny_inputs
    ckpt = tmp_path / "snap.orbax"
    assert main([params, obstacles, "--backend", "reference",
                 "--out-dir", str(tmp_path / "o"), "--checkpoint-every", "4",
                 "--checkpoint-format", "orbax",
                 "--checkpoint-path", str(ckpt)]) == 0
    assert ckpt.is_dir()


def test_cli_bf16_warns_experimental(tiny_inputs, tmp_path, capsys):
    """bf16 is experimental — the CLI must warn loudly that it cannot pass
    the 1% golden gate (c16 is the supported 16-bit mode)."""
    params, obstacles = tiny_inputs
    rc = main([params, obstacles, "--backend", "reference",
               "--precision", "bf16", "--out-dir", str(tmp_path / "o")])
    assert rc == 0
    err = capsys.readouterr().err
    assert "EXPERIMENTAL" in err and "c16" in err
    # ... and the supported modes stay silent.
    rc = main([params, obstacles, "--backend", "reference",
               "--precision", "c16", "--out-dir", str(tmp_path / "o2")])
    assert rc == 0
    assert "EXPERIMENTAL" not in capsys.readouterr().err


# Backend names of step kernels that no longer exist must be refused, not
# silently remapped.
REMOVED_BACKENDS = ["pallas", "resident", "aa", "temporal", "deep", "band",
                    "band2", "band3", "slab", "pallas-overlap"]


@pytest.mark.parametrize("backend", REMOVED_BACKENDS)
def test_cli_removed_backend_rejected(backend, tiny_inputs, tmp_path, capsys):
    params, obstacles = tiny_inputs
    with pytest.raises(SystemExit) as exc:
        main([params, obstacles, "--backend", backend,
              "--out-dir", str(tmp_path / "o")])
    assert exc.value.code == 2
    assert "invalid choice" in capsys.readouterr().err
    assert not (tmp_path / "o").exists()


@pytest.mark.parametrize("backend", ["auto", "reference"])
@pytest.mark.parametrize("precision", ["f32", "f64", "c16"])
def test_cli_backend_precision_matrix(backend, precision, tiny_inputs, tmp_path):
    """Every backend name that is left runs at every supported precision
    and agrees with the f32 reference run to the storage's resolution."""
    params, obstacles = tiny_inputs
    ref, out = tmp_path / "ref", tmp_path / "out"
    assert main([params, obstacles, "--backend", "reference",
                 "--out-dir", str(ref)]) == 0
    assert main([params, obstacles, "--backend", backend, "--precision",
                 precision, "--out-dir", str(out)]) == 0
    a = np.loadtxt(ref / "av_vels.dat", usecols=[1])
    b = np.loadtxt(out / "av_vels.dat", usecols=[1])
    np.testing.assert_allclose(b, a, rtol=2e-3 if precision == "c16" else 1e-5)


def test_cli_orbax_missing_is_a_clean_error(tiny_inputs, tmp_path, capsys,
                                            monkeypatch):
    """Without the optional orbax package, --checkpoint-format orbax is an
    ``lbm_tpu: error:`` and exit 1, not a traceback."""
    import sys

    monkeypatch.setitem(sys.modules, "orbax", None)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    params, obstacles = tiny_inputs
    rc = main([params, obstacles, "--checkpoint-every", "4",
               "--checkpoint-format", "orbax", "--out-dir", str(tmp_path / "o")])
    assert rc == 1
    assert "lbm_tpu: error:" in capsys.readouterr().err
