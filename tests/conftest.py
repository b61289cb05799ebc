"""Test configuration: force the CPU backend with 8 virtual devices so the
multi-device sharding path is exercised without GPUs (SURVEY.md §4).

Tests that need a GPU carry the ``gpu`` marker and skip here; they decide
inside the test, never at import time."""

import os
import sys

# Make the repo root importable regardless of how pytest was invoked.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# CPU unless the caller asks for a platform, e.g. JAX_PLATFORMS=cuda,cpu to
# run the ``gpu`` tests on a card.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import numpy as np
import pytest

# Force both knobs through jax.config too, before any backend initializes:
# a jax imported earlier in the process would not see the env var.
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_num_cpu_devices", 8)

# Unit tests compare against a float64 oracle; explicit f32 dtypes elsewhere
# keep the production-precision paths exercised too.
jax.config.update("jax_enable_x64", True)

from lbm_tpu.models.d2q9 import LBMParams


@pytest.fixture
def params128():
    from lbm_tpu.utils.decks import deck_params

    return deck_params("128x128")


@pytest.fixture
def obstacles128():
    from lbm_tpu.utils.decks import deck_obstacles

    return deck_obstacles("128x128")


@pytest.fixture
def gpu():
    """The first device, when it is an NVIDIA GPU; the test skips otherwise."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX found {device.platform!r})")
    return device


@pytest.fixture
def small_params():
    """A small non-square grid with a few obstacles for fast unit tests."""
    return LBMParams(
        nx=24, ny=16, max_iters=20, reynolds_dim=10, density=0.1, accel=0.005, omega=1.85
    )


@pytest.fixture
def small_obstacles(small_params):
    rng = np.random.RandomState(42)
    mask = np.zeros((small_params.ny, small_params.nx), dtype=np.int32)
    mask[0, :] = 1
    mask[-1, :] = 1
    mask[rng.randint(1, small_params.ny - 1, 10), rng.randint(0, small_params.nx, 10)] = 1
    return mask
