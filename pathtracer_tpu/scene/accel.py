"""Acceleration structure: uniform grid over triangles, flattened to CSR.

The reference builds a 64^3 uniform grid over the fixed world volume
[-WORLD_SIZE/2, WORLD_SIZE/2]^3 = [-2.5, 2.5]^3 and then merges it bottom-up
into a pointer octree (GenerateAccelerationStructure,
win32_main.cpp:1188-1447). Binning rule: each triangle is pushed into every
leaf voxel spanned by the axis-aligned bounding box *of the voxel
coordinates of its three vertices* (:1231-1382) — a conservative cover of
the triangle, so grid traversal visits every cell that can contain a hit.

On a lane-parallel device pointer trees don't fly; the octree's only
purpose is pruning, and
a uniform grid walked with a 3D-DDA prunes equally well for these scenes.
We keep the exact reference binning (same sep = WORLD_SIZE / 2^LEVELS, same
floor()+half convention :1261-1268) and flatten cell->triangle lists into
CSR arrays (cell_start, cell_count, tris) for stackless device traversal
(ops/traverse.py).

Out-of-bounds geometry asserts in the reference ("triangle is out of the
world bounds!", :1284-1286); we raise with the same meaning.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import jax.numpy as jnp

from .schema import LEVELS, WORLD_SIZE

GRID_RES = 1 << LEVELS          # 64 leaves per axis
CELL_SIZE = WORLD_SIZE / GRID_RES
GRID_MIN = -WORLD_SIZE / 2.0    # the voxel lattice spans [-2.5, 2.5]^3


def voxel_coords(points: np.ndarray) -> np.ndarray:
    """floor(p / sep) + halfLeavesCount per axis (win32_main.cpp:1266-1268)."""
    half = GRID_RES >> 1
    return np.floor(points / CELL_SIZE).astype(np.int64) + half


def build_uniform_grid(triangles: np.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, int]:
    """Bin triangles (T, 3, 3) into the 64^3 grid; returns
    (cell_start, cell_count, tris, grid_res) as device arrays + static res.

    Uses the native C++ builder (native/src/accel.cpp via pathtracer_tpu.native)
    when built, falling back to the numpy reference below; both produce
    identical CSR arrays (tests/test_native.py).
    """
    tris = np.asarray(triangles, np.float32)
    T = len(tris)

    from .. import native
    if native.available():
        result = native.grid_build_native(tris.reshape(T, 9), GRID_RES, CELL_SIZE)
        if result is not None:
            starts, counts, refs = result
            return (jnp.asarray(starts), jnp.asarray(counts),
                    jnp.asarray(refs), GRID_RES)

    coords = voxel_coords(tris.reshape(-1, 3)).reshape(T, 3, 3)  # (T, vert, axis)
    if coords.min() < 0 or coords.max() >= GRID_RES:
        raise ValueError(
            "triangle is out of the world bounds! either extend the world "
            "bounds or move the triangle (cf. win32_main.cpp:1284-1286)")

    lo = coords.min(axis=1)  # (T, 3) per-axis min voxel
    hi = coords.max(axis=1)

    # counts pass
    ncells = GRID_RES ** 3
    counts = np.zeros(ncells, np.int64)
    spans = []
    for t in range(T):
        xs = np.arange(lo[t, 0], hi[t, 0] + 1)
        ys = np.arange(lo[t, 1], hi[t, 1] + 1)
        zs = np.arange(lo[t, 2], hi[t, 2] + 1)
        zz, yy, xx = np.meshgrid(zs, ys, xs, indexing="ij")
        cells = (zz * GRID_RES * GRID_RES + yy * GRID_RES + xx).ravel()
        spans.append(cells)
        np.add.at(counts, cells, 1)

    starts = np.zeros(ncells + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    total = int(starts[-1])
    refs = np.zeros(max(total, 1), np.int32)
    cursor = starts[:-1].copy()
    for t in range(T):
        cells = spans[t]
        refs[cursor[cells]] = t
        cursor[cells] += 1

    return (
        jnp.asarray(starts[:-1].astype(np.int32)),
        jnp.asarray(counts.astype(np.int32)),
        jnp.asarray(refs),
        GRID_RES,
    )
