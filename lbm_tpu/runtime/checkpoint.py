"""Checkpoint / resume.

The reference has no resumable state (its only artifact, final_state.dat,
stores moments — not the 9 distributions). Here a checkpoint is either a
single ``.npz`` (default — atomic, dependency-free) or an orbax checkpoint
directory (``format="orbax"`` — the JAX-ecosystem standard, async-capable;
an optional dependency, imported only when asked for),
holding the full ``(9, ny, nx)`` distribution state, the av_vels prefix, the
completed step count, and the params for validation.
"""

from __future__ import annotations


import os
import tempfile

import numpy as np

from lbm_tpu.models.d2q9 import LBMParams

_FORMAT_VERSION = 1


def save_checkpoint(path, params: LBMParams, cells, av_vels, step: int) -> None:
    """Atomically write a checkpoint (write temp + rename)."""
    path = os.fspath(path)
    d = os.path.dirname(path) or "."
    # Mid-run snapshots can precede the first output write (which is what
    # creates --out-dir), so the parent must be created here.
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(
                f,
                version=_FORMAT_VERSION,
                cells=np.asarray(cells),
                av_vels=np.asarray(av_vels),
                step=int(step),
                params=np.array(
                    [
                        params.nx,
                        params.ny,
                        params.max_iters,
                        params.reynolds_dim,
                        params.density,
                        params.accel,
                        params.omega,
                    ],
                    dtype=np.float64,
                ),
            )
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path, params: LBMParams):
    """Load a checkpoint, validating it matches ``params``.

    Returns ``(cells, av_vels, step)``.
    """
    with np.load(path) as data:
        version = int(data["version"])
        if version != _FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {version}")
        saved = data["params"]
        expect = [
            params.nx,
            params.ny,
            params.max_iters,
            params.reynolds_dim,
            params.density,
            params.accel,
            params.omega,
        ]
        if not np.allclose(saved, np.array(expect, dtype=np.float64)):
            raise ValueError(
                f"checkpoint params {saved.tolist()} do not match run params "
                f"{[float(v) for v in expect]}"
            )
        return data["cells"], data["av_vels"], int(data["step"])


def _params_list(params: LBMParams):
    return [
        params.nx,
        params.ny,
        params.max_iters,
        params.reynolds_dim,
        params.density,
        params.accel,
        params.omega,
    ]


def save_checkpoint_orbax(path, params: LBMParams, cells, av_vels, step: int) -> None:
    """Orbax-backed snapshot (a checkpoint DIRECTORY at ``path``)."""
    import orbax.checkpoint as ocp

    path = os.path.abspath(os.fspath(path))
    with ocp.StandardCheckpointer() as ckptr:
        tree = {
            "version": np.int64(_FORMAT_VERSION),
            "cells": np.asarray(cells),
            "av_vels": np.asarray(av_vels),
            "step": np.int64(step),
            "params": np.array(_params_list(params), dtype=np.float64),
        }
        ckptr.save(path, tree, force=True)


def load_checkpoint_orbax(path, params: LBMParams):
    """Load an orbax checkpoint directory, validating against ``params``.

    Returns ``(cells, av_vels, step)``.
    """
    import orbax.checkpoint as ocp

    path = os.path.abspath(os.fspath(path))
    with ocp.StandardCheckpointer() as ckptr:
        tree = ckptr.restore(path)
    if int(tree["version"]) != _FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version {int(tree['version'])}")
    saved = np.asarray(tree["params"])
    expect = np.array(_params_list(params), dtype=np.float64)
    if not np.allclose(saved, expect):
        raise ValueError(
            f"checkpoint params {saved.tolist()} do not match run params "
            f"{expect.tolist()}"
        )
    return np.asarray(tree["cells"]), np.asarray(tree["av_vels"]), int(tree["step"])


FORMATS = ("npz", "orbax")


def save_checkpoint_as(
    path, params: LBMParams, cells, av_vels, step: int, format: str = "npz"
) -> None:
    """Format-dispatching save (``format`` in ``FORMATS``)."""
    if format == "npz":
        save_checkpoint(path, params, cells, av_vels, step)
    elif format == "orbax":
        save_checkpoint_orbax(path, params, cells, av_vels, step)
    else:
        raise ValueError(f"unknown checkpoint format {format!r}")


def load_checkpoint_as(path, params: LBMParams, format: str = "npz"):
    """Format-dispatching load; returns ``(cells, av_vels, step)``."""
    if format == "npz":
        return load_checkpoint(path, params)
    if format == "orbax":
        return load_checkpoint_orbax(path, params)
    raise ValueError(f"unknown checkpoint format {format!r}")
