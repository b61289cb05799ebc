"""c16 companded-16-bit deviation storage (ops/devspace.py: half the state
traffic of f32, and it passes the golden gate).

These tests pin the encode/decode contract per plane and per deck, the
driver surface (dtype="c16", checkpoint decode, saturation warning) and the
sharded c16 steps.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from lbm_tpu.models.d2q9 import LBMParams
from lbm_tpu.ops import devspace
from lbm_tpu.runtime.driver import run_simulation


@pytest.fixture
def spec():
    return devspace.DevSpec.for_params(density=0.1, accel=0.005)


def test_spec_defaults(spec):
    assert spec.h == pytest.approx(64.0 * 0.1 * 0.005)
    assert spec.bg[0] == pytest.approx(0.1 * 4.0 / 9.0)
    assert spec.bg[1] == spec.bg[3]  # opposite pairs share backgrounds
    assert spec.bg[5] == spec.bg[7]


def test_h_override(monkeypatch):
    monkeypatch.setenv("LBM_C16_H", "0.5")
    assert devspace.DevSpec.for_params(0.1, 0.005).h == 0.5
    monkeypatch.setenv("LBM_C16_H", "-1")
    with pytest.raises(ValueError, match="must be > 0"):
        devspace.DevSpec.for_params(0.1, 0.005)


def test_roundtrip_quantization_bound(spec):
    """decode(encode(d)) errs by at most one companding quantum
    2*sqrt(|d|*h)/LIM (+ the tiny-|d| floor h/LIM^2), across 12 orders of
    magnitude of deviation."""
    rng = np.random.RandomState(7)
    mag = 10.0 ** rng.uniform(-12, np.log10(spec.h * 0.99), 4096)
    d = jnp.asarray(mag * np.where(rng.rand(4096) < 0.5, -1, 1), jnp.float32)
    q = devspace.encode_value(d, spec.h)
    back = devspace.decode_value(q, spec.h)
    bound = 2.0 * np.sqrt(np.abs(np.asarray(d)) * spec.h) / devspace.LIM + (
        spec.h / devspace.LIM**2
    )
    np.testing.assert_array_less(np.abs(np.asarray(back - d)), bound)


def test_encode_clamps_out_of_range(spec):
    d = jnp.asarray([2 * spec.h, -3 * spec.h], jnp.float32)
    q = devspace.encode_value(d, spec.h)
    assert np.all(np.abs(np.asarray(q)) == devspace.LIM)


def test_state_roundtrip_exact_at_rest(spec):
    """The initial equilibrium-at-rest state IS the background: it encodes
    to all-zero deviations and decodes back bit-exactly."""
    from lbm_tpu.models.d2q9 import D2Q9

    p = LBMParams(nx=16, ny=16, max_iters=1, reynolds_dim=10,
                  density=0.1, accel=0.005, omega=1.85)
    cells = D2Q9.initial_state(p, dtype=jnp.float32)
    q = devspace.encode_state(cells, spec)
    assert int(np.abs(np.asarray(q)).max()) == 0
    np.testing.assert_array_equal(
        np.asarray(devspace.decode_state(q, spec)), np.asarray(cells)
    )


def _small(nx=128, ny=32, iters=8):
    p = LBMParams(nx=nx, ny=ny, max_iters=iters, reynolds_dim=10,
                  density=0.1, accel=0.005, omega=1.85)
    rng = np.random.RandomState(5)
    obs = np.zeros((ny, nx), dtype=np.int32)
    obs[0, :] = obs[-1, :] = 1
    obs[rng.randint(1, ny - 1, 6), rng.randint(0, nx, 6)] = 1
    return p, obs


def test_c16_auto_cpu_runs_reference_wrapper():
    """auto + c16 must run the decode/step/encode wrapper, never the raw
    reference step on companded ints."""
    p, obs = _small(nx=20, ny=12, iters=4)
    res = run_simulation(p, obs, backend="auto", dtype="c16")
    assert np.isfinite(res.av_vels).all()
    f32 = run_simulation(p, obs, backend="reference", dtype=jnp.float32)
    np.testing.assert_allclose(res.av_vels, f32.av_vels, rtol=2e-3, atol=1e-9)


def test_c16_checkpoint_stores_decoded_f32(tmp_path):
    from lbm_tpu.runtime.checkpoint import load_checkpoint

    p, obs = _small(iters=6)
    path = str(tmp_path / "ck.npz")
    run_simulation(p, obs, dtype="c16",
                   checkpoint_every=3, checkpoint_path=path)
    cells, av_vels, step = load_checkpoint(path, p)
    assert cells.dtype == np.float32
    assert step == 6
    # Resume from the decoded checkpoint: re-encode is a clean round-trip.
    p2 = dataclasses.replace(p, max_iters=8)
    res = run_simulation(
        p2, obs, dtype="c16", initial_cells=cells,
        start_step=step, av_vels_prefix=av_vels,
    )
    assert res.av_vels.shape == (8,)
    assert np.isfinite(res.av_vels).all()


def test_c16_saturation_warns():
    """A state whose deviations exceed H/2 triggers the failure-detection
    warning (devspace docstring: saturation means suspect results)."""
    p, obs = _small(iters=2)
    big = np.full((9, p.ny, p.nx), 0.5, np.float32)  # huge deviations
    with pytest.warns(UserWarning, match="saturated"):
        run_simulation(p, obs, dtype="c16", initial_cells=big)


def test_c16_saturation_warns_without_fetch():
    """The saturation guard also fires on fetch_final=False timing runs —
    it derives max|deviation| from the on-device int16 codes, never the
    full state fetch."""
    p, obs = _small(iters=2)
    big = np.full((9, p.ny, p.nx), 0.5, np.float32)
    with pytest.warns(UserWarning, match="saturated"):
        res = run_simulation(p, obs, dtype="c16",
                             initial_cells=big, fetch_final=False)
    assert res.cells is None


@pytest.mark.slow
def test_c16_golden_gate_128x128():
    """The headline claim: c16 storage passes the upstream 1% golden gate at
    the full official 128x128 config (40k steps), with margin, against the
    in-tree f64 gold."""
    from lbm_tpu.utils.decks import deck_obstacles, deck_params, load_gold

    params = deck_params("128x128")
    obstacles = deck_obstacles("128x128")
    res = run_simulation(params, obstacles, backend="reference", dtype="c16")

    gold = load_gold("128x128")
    ref_av = gold["av_vels"]
    av_diff = 100.0 * (ref_av - res.av_vels) / res.av_vels
    assert np.max(np.abs(av_diff)) < 0.5, np.max(np.abs(av_diff))

    from lbm_tpu.ops.reference import velocity_field

    _, _, _, pressure = velocity_field(
        jnp.asarray(res.cells), jnp.asarray(np.asarray(obstacles))
    )
    ref_p = gold["pressure"].ravel()
    sim_p = np.where(
        np.asarray(obstacles).ravel() == 1,
        params.density / 3.0,
        np.asarray(pressure).ravel(),
    )
    p_diff = 100.0 * (ref_p - sim_p) / sim_p
    assert np.max(np.abs(p_diff)) < 0.5, np.max(np.abs(p_diff))


def test_c16_sharded_matches_single_device():
    """c16 over a 1-D mesh (decode/step/encode per shard) matches the
    single-device c16 run: identical storage rounding points."""
    from lbm_tpu.parallel.sharded import run_simulation_sharded

    p, obs = _small(nx=128, ny=64, iters=4)
    single = run_simulation(p, obs, dtype="c16")
    sharded = run_simulation_sharded(p, obs, n_devices=2, dtype="c16")
    assert sharded.cells.dtype == np.float32  # decoded
    assert sharded.av_vels.dtype == np.float32
    np.testing.assert_allclose(sharded.cells, single.cells, atol=5e-6)
    np.testing.assert_allclose(sharded.av_vels, single.av_vels,
                               rtol=1e-3, atol=1e-9)


def test_c16_sharded_jnp_fallback():
    """auto + c16 on a mesh runs the decode/step/encode jnp shard step
    (vma-checked) and stays close to the f32 sharded run."""
    from lbm_tpu.parallel.sharded import run_simulation_sharded

    p, obs = _small(nx=128, ny=64, iters=4)
    c16 = run_simulation_sharded(p, obs, n_devices=4, backend="auto",
                                 dtype="c16")
    f32 = run_simulation_sharded(p, obs, n_devices=4, backend="auto",
                                 dtype=jnp.float32)
    np.testing.assert_allclose(c16.cells, f32.cells, atol=1e-5)
    np.testing.assert_allclose(c16.av_vels, f32.av_vels, rtol=2e-3, atol=1e-9)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (2, 4)])
def test_c16_sharded_2d_matches_single_device(mesh_shape):
    """c16 on a 2-D (rows x cols) mesh (decode/step/encode jnp shard step,
    vma-checked) matches the single-device c16 reference run: identical
    storage rounding points, halos exchanged post-encode."""
    from lbm_tpu.parallel.sharded import run_simulation_sharded_2d

    p, obs = _small(nx=24, ny=16, iters=4)
    single = run_simulation(p, obs, backend="reference", dtype="c16")
    sharded = run_simulation_sharded_2d(p, obs, mesh_shape=mesh_shape,
                                        dtype="c16")
    assert sharded.cells.dtype == np.float32  # decoded
    assert sharded.av_vels.dtype == np.float32
    np.testing.assert_allclose(sharded.cells, single.cells, atol=5e-6)
    np.testing.assert_allclose(sharded.av_vels, single.av_vels,
                               rtol=1e-3, atol=1e-9)


def test_c16_sharded_2d_checkpoint_resume(tmp_path):
    """2-D-mesh c16 checkpoints store decoded f32 and resume cleanly."""
    from lbm_tpu.parallel.sharded import run_simulation_sharded_2d
    from lbm_tpu.runtime.checkpoint import load_checkpoint

    p, obs = _small(nx=24, ny=16, iters=6)
    path = str(tmp_path / "ck.npz")
    full = run_simulation_sharded_2d(p, obs, mesh_shape=(2, 2), dtype="c16")
    p3 = dataclasses.replace(p, max_iters=3)
    run_simulation_sharded_2d(p3, obs, mesh_shape=(2, 2), dtype="c16",
                              checkpoint_every=3, checkpoint_path=path)
    cells, av_vels, step = load_checkpoint(path, p3)
    assert cells.dtype == np.float32
    assert step == 3
    resumed = run_simulation_sharded_2d(
        p, obs, mesh_shape=(2, 2), dtype="c16", initial_cells=cells,
        start_step=step, av_vels_prefix=av_vels,
    )
    # Resume re-encodes the decoded snapshot — an exact round-trip, so the
    # resumed run reproduces the uninterrupted one bit-for-bit.
    np.testing.assert_array_equal(resumed.av_vels, full.av_vels)
    np.testing.assert_array_equal(resumed.cells, full.cells)


@pytest.mark.parametrize("tag", ["128x128", "128x256", "256x256", "1024x1024"])
@pytest.mark.parametrize("k", range(9))
def test_codec_plane_roundtrip_per_deck(tag, k):
    """Per speed slot k and per reference deck's (density, accel): full
    values around the plane's background survive encode_plane/decode_plane
    within one companding quantum, and the background itself is exact."""
    from lbm_tpu.utils.decks import deck_params

    params = deck_params(tag)
    spec = devspace.DevSpec.for_params(params.density, params.accel)
    rng = np.random.RandomState(100 + k)
    d = (rng.uniform(-1.0, 1.0, (8, 64)) ** 3) * 0.9 * spec.h
    full = jnp.asarray(spec.bg[k] + d, jnp.float32)
    q = devspace.encode_plane(full, k, spec)
    assert q.dtype == jnp.int16
    back = np.asarray(devspace.decode_plane(q, k, spec), np.float64)
    dev = np.asarray(full, np.float64) - spec.bg[k]
    # one quantum of the sqrt companding, plus f32 rounding of the full value
    bound = (2.0 * np.sqrt(np.abs(dev) * spec.h) / devspace.LIM
             + spec.h / devspace.LIM**2 + 2 * np.spacing(np.float32(spec.bg[k])))
    np.testing.assert_array_less(np.abs(back - np.asarray(full, np.float64)), bound)
    at_bg = devspace.encode_plane(jnp.full((2, 2), spec.bg[k], jnp.float32), k, spec)
    assert int(np.abs(np.asarray(at_bg)).max()) == 0
