"""Unit tests for multi-host initialization (parallel/multihost.py).

A real cluster isn't available here, so ``jax.distributed.initialize`` is
mocked; these cover the env-var parsing and the no-cluster branch, plus one
genuine two-process run on the CPU."""

import jax
import jax.numpy as jnp
import pytest

from lbm_tpu.parallel.multihost import initialize_multihost


@pytest.fixture
def recorded(monkeypatch):
    calls = []

    def fake_initialize(*args, **kwargs):
        calls.append((args, kwargs))

    monkeypatch.setattr(jax.distributed, "initialize", fake_initialize)
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    return calls


def test_explicit_args(recorded):
    initialize_multihost("host0:1234", 4, 2)
    assert recorded == [
        ((), {"coordinator_address": "host0:1234", "num_processes": 4, "process_id": 2})
    ]


def test_env_vars(recorded, monkeypatch):
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "coord:8476")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "16")
    monkeypatch.setenv("JAX_PROCESS_ID", "3")
    initialize_multihost()
    assert recorded == [
        ((), {"coordinator_address": "coord:8476", "num_processes": 16, "process_id": 3})
    ]


def test_explicit_args_override_env(recorded, monkeypatch):
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "env:1")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "8")
    initialize_multihost(coordinator_address="arg:2")
    (_, kwargs), = recorded
    assert kwargs["coordinator_address"] == "arg:2"
    assert kwargs["num_processes"] == 8  # env still fills the gaps


def test_unconfigured_tries_autodetect(recorded):
    """No env, no args: nothing to detect — a single-process run needs no
    distributed setup, so ``jax.distributed.initialize`` is not called."""
    initialize_multihost()
    assert recorded == []


def test_unconfigured_failure_is_swallowed(monkeypatch):
    """A plain single-process run keeps working even where
    ``jax.distributed.initialize`` would raise: it is never called."""

    def boom(*args, **kwargs):
        raise RuntimeError("no coordinator")

    monkeypatch.setattr(jax.distributed, "initialize", boom)
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    initialize_multihost()  # must not raise


def test_configured_failure_propagates(monkeypatch):
    """With an explicit multi-process configuration, a failed init is an
    error the user must see, not a silent single-host fallback."""

    def boom(*args, **kwargs):
        raise RuntimeError("coordinator unreachable")

    monkeypatch.setattr(jax.distributed, "initialize", boom)
    with pytest.raises(RuntimeError, match="unreachable"):
        initialize_multihost("host0:1234", 4, 0)


def test_bad_env_value(monkeypatch, recorded):
    monkeypatch.setenv("JAX_NUM_PROCESSES", "not-a-number")
    with pytest.raises(ValueError):
        initialize_multihost()


def test_real_two_process_distributed_run(tmp_path):
    """GENUINE multi-process validation: two spawned CPU processes, localhost coordinator, 4 virtual devices each;
    the sharded loop spans all 8 via Gloo cross-process collectives and
    both processes' gathered results must equal the single-process run."""
    import os
    import socket
    import subprocess
    import sys

    import numpy as np

    from lbm_tpu.runtime.driver import run_simulation

    with socket.socket() as s:  # pick a free coordinator port
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(repo, "tests", "multihost_worker.py")
    env = dict(os.environ, PYTHONPATH=repo, JAX_PLATFORMS="cpu")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), "2", str(port),
             str(tmp_path / f"out{i}.npz")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out.decode(errors="replace"))
    assert all(p.returncode == 0 for p in procs), "\n".join(outs)

    # Single-process reference on the same config (worker's params/geometry).
    from lbm_tpu.models.d2q9 import LBMParams

    params = LBMParams(
        nx=16, ny=16, max_iters=5, reynolds_dim=10,
        density=0.1, accel=0.005, omega=1.85,
    )
    rng = np.random.RandomState(3)
    obs = np.zeros((params.ny, params.nx), dtype=np.int32)
    obs[0, :] = obs[-1, :] = 1
    obs[rng.randint(1, params.ny - 1, 6), rng.randint(0, params.nx, 6)] = 1
    single = run_simulation(params, obs, backend="reference", dtype=jnp.float64)

    for i in range(2):
        got = np.load(tmp_path / f"out{i}.npz")
        np.testing.assert_allclose(got["cells"], single.cells, rtol=1e-11)
        np.testing.assert_allclose(got["av_vels"], single.av_vels, rtol=1e-10)
