"""Progressive rendering: checkpoint/resume of the accumulator state.

The reference has no checkpointing (SURVEY.md §5: a render runs
start-to-finish; the live Win32 viewer shows partial results but nothing is
persisted). The renderer's accumulator (sum, sum_sq, count, diagnostics) IS
the complete render state: saving it at any chunk boundary allows exact
resume — the counter-based PRNG guarantees the remaining samples are the
same ones that would have been traced without the interruption.

Format: a plain .npz (atomic rename) — no framework dependency for a few
MB of state. Orbax is used by the larger training-style flows if needed.
"""

from __future__ import annotations

import os
import tempfile
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from ..utils.vec import Vec3
from .renderer import AccumState, init_accum

_FORMAT_VERSION = 1


def save_checkpoint(path: str, state: AccumState) -> None:
    """Atomically persist the accumulator."""
    tmp_fd, tmp_path = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                                        suffix=".ckpt.tmp")
    os.close(tmp_fd)
    try:
        np.savez(
            tmp_path,
            version=_FORMAT_VERSION,
            sum_x=np.asarray(state.sum.x), sum_y=np.asarray(state.sum.y),
            sum_z=np.asarray(state.sum.z),
            sq_x=np.asarray(state.sum_sq.x), sq_y=np.asarray(state.sum_sq.y),
            sq_z=np.asarray(state.sum_sq.z),
            count=np.asarray(state.count),
            nan_count=np.asarray(state.nan_count),
            rays_cast=np.asarray(state.rays_cast),
            samples_done=np.asarray(state.samples_done),
        )
        os.replace(tmp_path + ".npz", path)
    finally:
        if os.path.exists(tmp_path):
            os.unlink(tmp_path)


def load_checkpoint(path: str, n_pixels: int) -> Tuple[AccumState, bool]:
    """Load accumulator; returns (state, found). Missing/mismatched files
    return a fresh accumulator (render starts over, never crashes)."""
    if not os.path.exists(path):
        return init_accum(n_pixels), False
    try:
        z = np.load(path)
        if int(z["version"]) != _FORMAT_VERSION or z["count"].shape[0] != n_pixels:
            return init_accum(n_pixels), False
        state = AccumState(
            sum=Vec3(jnp.asarray(z["sum_x"]), jnp.asarray(z["sum_y"]),
                     jnp.asarray(z["sum_z"])),
            sum_sq=Vec3(jnp.asarray(z["sq_x"]), jnp.asarray(z["sq_y"]),
                        jnp.asarray(z["sq_z"])),
            count=jnp.asarray(z["count"]),
            nan_count=jnp.asarray(z["nan_count"]),
            rays_cast=jnp.asarray(z["rays_cast"]),
            samples_done=jnp.asarray(z["samples_done"]),
        )
        return state, True
    except (OSError, KeyError, ValueError):
        return init_accum(n_pixels), False


def samples_done(state: AccumState) -> int:
    """Number of completed whole-image samples (for resume bookkeeping)."""
    return int(np.asarray(state.samples_done))
