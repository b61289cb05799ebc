"""c16: gate-passing companded 16-bit deviation storage.

The reference's 1% golden gate (check/check.py:26-31) fails catastrophically
under plain bf16 storage (av_vels drifts ~100%): bf16's 8-bit
mantissa rounds the full distribution values, whose O(w_k*density) mean
dwarfs the ~1e-3 hydrodynamic signal. c16 stores what actually carries
information — the per-plane DEVIATION from the equilibrium-at-rest
background ``bg_k = w_k * density`` (the exact initial state,
d2q9-bgk.c:572-594) — as a sqrt-companded int16:

    q   = rint( LIM * sign(d) * sqrt(|d| / H) )      (encode, clamped)
    d   = (q/LIM) * |q/LIM| * H                      (decode)

The sqrt companding makes the absolute quantization step scale like
``2*sqrt(|d|*H)/LIM`` — 4e-9 at |d|=1e-6, 5e-7 at the observed deviation
maxima — finer than IEEE float16 across the whole occupied range. Measured
on the reference configs in a CPU study: av_vels max diff ~0.07-0.3% vs the
1% tolerance, indistinguishable from f32, where plain-bf16 deviation storage
fails at 3.9% and uniform int16 at 1.15%.

Everything except the load/store boundary is unchanged: the background is
uniform, so streaming commutes with it, bounce-back swaps opposite planes
of EQUAL weight (kernels.cl:100-107 pairs share w_k, so bg_opp == bg_k),
and the accelerate-flow deltas are additive. The step decodes to f32 right
after load and encodes right before store; all physics runs at full f32.

``H`` (the largest representable |deviation|) defaults to
``64 * density * accel``: the observed per-config maxima are 3.8-17x
``density*accel`` (lid forcing drives all deviations; the channel geometry
runs hotter than the box), so 64x leaves >=3.8x headroom at a sqrt(2)
resolution cost (irrelevant against the ~15x accuracy margin). Saturation
is clamped (graceful) but degrades accuracy, so the driver warns post-run
if the final state's deviations exceeded H/2. ``LBM_C16_H`` overrides.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from lbm_tpu.models.d2q9 import W0, W1, W2

LIM = 32767.0

_WS = (W0, W1, W1, W1, W1, W2, W2, W2, W2)


@dataclasses.dataclass(frozen=True)
class DevSpec:
    """Static companding parameters (hashable: safe as a jit static arg)."""

    bg: tuple  # 9 per-plane background values w_k * density
    h: float   # max representable |deviation|

    @classmethod
    def for_params(cls, density: float, accel: float) -> "DevSpec":
        import os

        override = os.environ.get("LBM_C16_H")
        if override:
            h = float(override)
            if h <= 0.0:
                raise ValueError(f"LBM_C16_H={override}: must be > 0")
        else:
            h = 64.0 * float(density) * float(accel)
            if h <= 0.0:
                h = max(float(density) / 32.0, 1e-30)
        return cls(bg=tuple(float(w * density) for w in _WS), h=h)


def encode_value(d, h: float):
    """f32 deviation -> companded value in [-LIM, LIM] (pre-int-cast)."""
    s = jnp.sign(d) * jnp.sqrt(jnp.abs(d) * (1.0 / h))
    return jnp.clip(jnp.rint(s * LIM), -LIM, LIM)


def decode_value(q, h: float):
    """Companded value (as f32) -> f32 deviation."""
    r = q * (1.0 / LIM)
    return r * jnp.abs(r) * h


def encode_plane(f, k: int, spec: DevSpec):
    """Full f32 plane k -> int16 companded deviations."""
    return encode_value(f - spec.bg[k], spec.h).astype(jnp.int16)


def decode_plane(q, k: int, spec: DevSpec):
    """int16 (or pre-cast f32) companded plane k -> full f32 values."""
    return decode_value(q.astype(jnp.float32), spec.h) + spec.bg[k]


def encode_state(cells, spec: DevSpec):
    """(9, ny, nx) f32 state -> int16 companded deviations."""
    cells = jnp.asarray(cells, jnp.float32)
    return jnp.stack([encode_plane(cells[k], k, spec) for k in range(9)])


def decode_state(q, spec: DevSpec):
    """(9, ny, nx) int16 companded deviations -> f32 state."""
    return jnp.stack([decode_plane(q[k], k, spec) for k in range(9)])


def lbm_step_reference_c16(state, obstacles, density, accel, omega, dev=None):
    """c16 wrapper around the jnp reference step: decode → step → encode.

    One encode per step: the storage-rounding points any c16 kernel must
    reproduce. ``dev`` is the static ``(bg0..bg8, h)`` tuple the driver
    threads through (driver._run_loop).
    """
    from lbm_tpu.ops.reference import lbm_step_reference

    spec = DevSpec(bg=tuple(dev[:9]), h=float(dev[9]))
    full = decode_state(state, spec)
    new, tot_u = lbm_step_reference(full, obstacles, density, accel, omega)
    return encode_state(new, spec), tot_u
