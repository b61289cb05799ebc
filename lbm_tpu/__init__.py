"""lbm_tpu — a D2Q9 lattice-Boltzmann framework in JAX.

A from-scratch rebuild of the capability surface of the reference
HPC-Lattice-Boltzmann solver (C + OpenCL, single GPU) as an idiomatic
JAX / XLA framework, run on an NVIDIA GPU:

- ``lbm_tpu.models``   — the D2Q9/BGK lattice model (constants, equilibrium,
                         simulation spec).
- ``lbm_tpu.ops``      — compute ops: the jnp step (the main path and the
                         correctness oracle) and the c16 storage codec.
- ``lbm_tpu.parallel`` — multi-chip domain decomposition: ``shard_map`` over a
                         device mesh with ``lax.ppermute`` halo exchange and
                         ``psum`` reductions.
- ``lbm_tpu.runtime``  — the simulation driver: one jitted ``lax.fori_loop``
                         over all timesteps with the per-step reduction kept
                         on device (no host round-trips), plus checkpointing.
- ``lbm_tpu.io``       — params/obstacle parsers and output writers that are
                         byte-format compatible with the reference
                         (``final_state.dat`` / ``av_vels.dat``), with an
                         optional native C++ fast path.
- ``lbm_tpu.utils``    — result checker (py3 mirror of the reference
                         ``check/check.py`` semantics), timing, diagnostics.

Reference behavior parity is cited throughout as ``d2q9-bgk.c:<line>`` /
``kernels.cl:<line>`` into the upstream repo.
"""

from lbm_tpu.models.d2q9 import D2Q9, LBMParams
from lbm_tpu.runtime.driver import SimulationResult, run_simulation

__version__ = "0.1.0"

__all__ = [
    "D2Q9",
    "LBMParams",
    "SimulationResult",
    "run_simulation",
    "__version__",
]

from lbm_tpu.api import Simulation  # noqa: E402

__all__.append("Simulation")
