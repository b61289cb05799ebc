"""chip_smoke.py on the CPU: it refuses to report without a GPU, its result
line has the exact contract form, and its phases check what they claim at
tiny sizes (the full sizes run on the card)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke


@pytest.mark.parametrize("argv", [[], ["--four-gpus"]])
def test_refuses_cpu_platform(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main(argv)
    assert exc.value.code not in (0, None)
    assert "no GPU" in str(exc.value.code)
    assert '"ok"' not in capsys.readouterr().out


def test_result_line_exact_form():
    line = chip_smoke.result_line("NVIDIA H100 80GB HBM3", 1)
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line) == {
        "ok": True, "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                               "count": 1}}


def test_initial_mass_matches_stored_state():
    from lbm_tpu.models.d2q9 import D2Q9

    params = chip_smoke.hbm_params(16, 1)
    for dtype in (jnp.float32, jnp.float64):
        state = np.asarray(D2Q9.initial_state(params, dtype=dtype))
        assert chip_smoke.initial_mass(params, dtype) == pytest.approx(
            float(np.sum(state, dtype=np.float64)), rel=1e-15)


def test_hbm_phase_small(capsys):
    out = chip_smoke.hbm_phase(side=32, steps=40)
    assert out["av_pct"] < 0.1
    printed = capsys.readouterr().out
    assert printed.count("[hbm] {") == 2 and "float64" in printed


def test_failed_phase_exits_nonzero(monkeypatch):
    monkeypatch.setitem(chip_smoke.MASS_RTOL, "float32", 0.0)
    with pytest.raises(SystemExit, match="mass drifted"):
        chip_smoke.hbm_phase(side=16, steps=30)


@pytest.mark.parametrize("mesh, cards", [(4, 4), (8, 8), ((2, 2), 4), ((2, 4), 8)])
def test_shards_land_on_distinct_devices(mesh, cards):
    assert chip_smoke._distinct_shard_devices(mesh) == cards


def test_mesh_phase_small(capsys):
    rows = chip_smoke.mesh_phase(side=32, steps=12, meshes=(4, (2, 2)))
    assert [r["mesh"] for r in rows] == ["4", "2x2"]
    assert all(r["devices_holding_shards"] == 4 for r in rows)
    assert all(r["state_max_abs_diff"] <= chip_smoke.MESH_STATE_ATOL for r in rows)


def test_deck_phase_128x128_full_run(tmp_path):
    """The 128x128 deck at its full 40k steps through the CLI, checked
    against its gold at the 1% gate — the smoke script's deck phase."""
    row = chip_smoke.deck_phase("128x128", str(tmp_path))
    assert abs(row["av_max_diff_pct"]) <= chip_smoke.DECK_AV_PCT
    assert abs(row["fs_max_diff_pct"]) <= chip_smoke.GATE_PCT
    assert row["mlups"] > 0
