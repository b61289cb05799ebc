"""Device selection.

The reference enumerates OpenCL devices, prints the list, and honours an
``OCL_DEVICE`` index override from the environment (d2q9-bgk.c:950-1007,
job_submit_d2q9-bgk:16-18). The JAX equivalent enumerates
``jax.devices()`` and honours ``LBM_DEVICE`` (or an explicit ``--device``
index).
"""

from __future__ import annotations

import os
import sys


def list_devices() -> list:
    import jax

    return jax.devices()


def format_device_list() -> str:
    """Human-readable device table (the reference's startup printout,
    d2q9-bgk.c:975-981)."""
    lines = ["", "Available devices:"]
    for i, d in enumerate(list_devices()):
        lines.append("%2d: %s (%s)" % (i, d.device_kind, d.platform))
    lines.append("")
    return "\n".join(lines)


def format_selected(device) -> str:
    """The reference's selection printout (d2q9-bgk.c:1002-1004)."""
    return "Selected device:\n-> %s (index=%d)\n" % (device.device_kind, device.id)


def select_device(index: int | None = None):
    """Pick the compute device: explicit index > ``LBM_DEVICE`` env > first.

    Returns the jax Device. Raises IndexError with the device list on a bad
    index (mirroring the reference's fatal error, d2q9-bgk.c:985-999).
    """
    devices = list_devices()
    if index is None:
        env = os.environ.get("LBM_DEVICE")
        if env is not None:
            try:
                index = int(env)
            except ValueError as e:
                raise ValueError(f"LBM_DEVICE={env!r} is not an integer") from e
    if index is None:
        return devices[0]
    if not 0 <= index < len(devices):
        raise IndexError(
            f"device index {index} out of range\n{format_device_list()}"
        )
    return devices[index]


def print_devices(file=sys.stderr) -> None:
    print(format_device_list(), file=file)


def gpu_name_and_power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (``name, power.limit``), or a note saying why there is none. A card set
    below its maximum power runs slower under load, so every measured number
    is reported beside this line."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"
