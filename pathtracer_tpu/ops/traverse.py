"""Stackless uniform-grid traversal on device (3D-DDA over CSR cell lists).

Replaces the reference's pointer-octree traversal with an explicit
thread-local node stack (win32_main.cpp:476-526). A per-lane stack of
pointers is hostile to lane-parallel code; instead each lane walks the
64^3 leaf grid
with a 3D-DDA — visiting exactly the leaves the octree descent would reach —
and tests the triangles binned into each visited cell (scene/accel.py, same
binning as win32_main.cpp:1231-1382).

Correctness argument (vs. brute force over all triangles): the binning
covers every voxel spanned by the triangle's vertex-bbox, a superset of the
triangle, so any ray-triangle hit point lies in a visited cell that lists
that triangle. The walk stops once the next cell's entry distance exceeds
the current best hit (no closer hit can appear later along the ray), or the
ray leaves the grid volume. Identical results to
intersect.intersect_triangles_brute are enforced by tests/test_accel.py.

Implementation: one lax.while_loop whose body advances *every* lane by one
unit of work — either testing one triangle from its current cell's CSR
range, or DDA-stepping to the next cell. Lanes that finish early idle
(masked); the loop ends when all lanes are done.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..scene.schema import Scene
from ..utils.vec import Vec3, cross, normalize
from .intersect import Hit, ray_planar_triangle

_BIG = 1e30


class _WalkState(NamedTuple):
    marching: jnp.ndarray          # lane still has work
    cx: jnp.ndarray                # current cell coords (int32)
    cy: jnp.ndarray
    cz: jnp.ndarray
    tnx: jnp.ndarray               # next axis-crossing t
    tny: jnp.ndarray
    tnz: jnp.ndarray
    cursor: jnp.ndarray            # CSR cursor/end into grid_tris
    end: jnp.ndarray
    t: jnp.ndarray                 # best hit so far
    mat: jnp.ndarray
    nx: jnp.ndarray
    ny: jnp.ndarray
    nz: jnp.ndarray


def intersect_triangles_grid(scene: Scene, o: Vec3, d: Vec3, best: Hit) -> Hit:
    res = scene.grid_res
    from ..scene.accel import CELL_SIZE, GRID_MIN
    cell = CELL_SIZE
    gmin = GRID_MIN
    gmax = -GRID_MIN

    # slab test with the grid volume
    invx = 1.0 / jnp.where(d.x != 0.0, d.x, 1e-30)
    invy = 1.0 / jnp.where(d.y != 0.0, d.y, 1e-30)
    invz = 1.0 / jnp.where(d.z != 0.0, d.z, 1e-30)
    t0x, t1x = (gmin - o.x) * invx, (gmax - o.x) * invx
    t0y, t1y = (gmin - o.y) * invy, (gmax - o.y) * invy
    t0z, t1z = (gmin - o.z) * invz, (gmax - o.z) * invz
    tmin = jnp.maximum(jnp.maximum(jnp.minimum(t0x, t1x), jnp.minimum(t0y, t1y)),
                       jnp.minimum(t0z, t1z))
    tmax = jnp.minimum(jnp.minimum(jnp.maximum(t0x, t1x), jnp.maximum(t0y, t1y)),
                       jnp.maximum(t0z, t1z))
    in_box = (tmax >= tmin) & (tmax >= 0.0)

    t_entry = jnp.maximum(tmin, 0.0) + 1e-7
    px = o.x + d.x * t_entry
    py = o.y + d.y * t_entry
    pz = o.z + d.z * t_entry
    cx = jnp.clip(jnp.floor((px - gmin) / cell).astype(jnp.int32), 0, res - 1)
    cy = jnp.clip(jnp.floor((py - gmin) / cell).astype(jnp.int32), 0, res - 1)
    cz = jnp.clip(jnp.floor((pz - gmin) / cell).astype(jnp.int32), 0, res - 1)

    stepx = jnp.where(d.x > 0, 1, -1).astype(jnp.int32)
    stepy = jnp.where(d.y > 0, 1, -1).astype(jnp.int32)
    stepz = jnp.where(d.z > 0, 1, -1).astype(jnp.int32)

    def next_t(c, stp, ov, dv, inv):
        bound = gmin + (c + (stp > 0)).astype(jnp.float32) * cell
        return jnp.where(dv != 0.0, (bound - ov) * inv, _BIG)

    tnx = next_t(cx, stepx, o.x, d.x, invx)
    tny = next_t(cy, stepy, o.y, d.y, invy)
    tnz = next_t(cz, stepz, o.z, d.z, invz)
    tdx = jnp.where(d.x != 0.0, jnp.abs(cell * invx), _BIG)
    tdy = jnp.where(d.y != 0.0, jnp.abs(cell * invy), _BIG)
    tdz = jnp.where(d.z != 0.0, jnp.abs(cell * invz), _BIG)

    cell_idx = (cz * res + cy) * res + cx
    cursor = jnp.where(in_box, scene.grid_cell_start[cell_idx], 0)
    end = jnp.where(in_box, cursor + scene.grid_cell_count[cell_idx], 0)

    st = _WalkState(
        marching=in_box, cx=cx, cy=cy, cz=cz, tnx=tnx, tny=tny, tnz=tnz,
        cursor=cursor.astype(jnp.int32), end=end.astype(jnp.int32),
        t=best.t, mat=best.mat,
        nx=best.normal.x, ny=best.normal.y, nz=best.normal.z,
    )

    def cond(s: _WalkState):
        return jnp.any(s.marching)

    def body(s: _WalkState) -> _WalkState:
        testing = s.marching & (s.cursor < s.end)

        # --- test one triangle per testing lane ---------------------------
        tri = scene.grid_tris[jnp.minimum(s.cursor, scene.grid_tris.shape[0] - 1)]
        A = Vec3(scene.tri_a.x[tri], scene.tri_a.y[tri], scene.tri_a.z[tri])
        U = Vec3(scene.tri_u.x[tri], scene.tri_u.y[tri], scene.tri_u.z[tri])
        V = Vec3(scene.tri_v.x[tri], scene.tri_v.y[tri], scene.tri_v.z[tri])
        thit, hit = ray_planar_triangle(o, d, A, U, V)
        n = normalize(cross(U, V), eps=1e-30)
        take = testing & hit & (thit < s.t)
        t_new = jnp.where(take, thit, s.t)
        mat_new = jnp.where(take, scene.tri_mat[tri], s.mat)
        nx = jnp.where(take, n.x, s.nx)
        ny = jnp.where(take, n.y, s.ny)
        nz = jnp.where(take, n.z, s.nz)
        cursor_new = jnp.where(testing, s.cursor + 1, s.cursor)

        # --- DDA step for lanes whose cell is exhausted --------------------
        stepping = s.marching & ~testing
        t_enter_next = jnp.minimum(jnp.minimum(s.tnx, s.tny), s.tnz)
        ax_x = (s.tnx <= s.tny) & (s.tnx <= s.tnz)
        ax_y = ~ax_x & (s.tny <= s.tnz)
        ax_z = ~ax_x & ~ax_y
        ncx = s.cx + jnp.where(ax_x, stepx, 0)
        ncy = s.cy + jnp.where(ax_y, stepy, 0)
        ncz = s.cz + jnp.where(ax_z, stepz, 0)
        ntnx = s.tnx + jnp.where(ax_x, tdx, 0.0)
        ntny = s.tny + jnp.where(ax_y, tdy, 0.0)
        ntnz = s.tnz + jnp.where(ax_z, tdz, 0.0)
        inside = (
            (ncx >= 0) & (ncx < res) & (ncy >= 0) & (ncy < res)
            & (ncz >= 0) & (ncz < res)
        )
        keep_going = stepping & inside & (t_enter_next <= t_new) & (t_enter_next <= tmax)

        new_cell = (ncz * res + ncy) * res + ncx
        new_cell = jnp.clip(new_cell, 0, res * res * res - 1)
        c_start = scene.grid_cell_start[new_cell]
        c_count = scene.grid_cell_count[new_cell]

        return _WalkState(
            marching=jnp.where(stepping, keep_going, s.marching),
            cx=jnp.where(keep_going, ncx, s.cx),
            cy=jnp.where(keep_going, ncy, s.cy),
            cz=jnp.where(keep_going, ncz, s.cz),
            tnx=jnp.where(keep_going, ntnx, s.tnx),
            tny=jnp.where(keep_going, ntny, s.tny),
            tnz=jnp.where(keep_going, ntnz, s.tnz),
            cursor=jnp.where(keep_going, c_start, cursor_new),
            end=jnp.where(keep_going, c_start + c_count, s.end),
            t=t_new, mat=mat_new, nx=nx, ny=ny, nz=nz,
        )

    st = jax.lax.while_loop(cond, body, st)
    return Hit(st.t, st.mat, Vec3(st.nx, st.ny, st.nz))
