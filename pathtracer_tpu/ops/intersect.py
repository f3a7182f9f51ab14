"""Batched ray-primitive intersection (lane-parallel over rays).

Each function intersects a batch of N rays (SoA Vec3) against ONE primitive
whose parameters are scalars or broadcastable arrays; the scene-level
dispatcher scans the (static-shape, masked) primitive tables with
``lax.fori_loop`` carrying the running nearest hit. Semantics are exact
batched translations of the reference's scalar intersectors:

- RaySphereIntersect           (win32_main.cpp:2355-2379)
- RayIntersectPlane            (ray_math.hpp:334-341)
- RayIntersectPlanarShape<T|Q> (ray_math.hpp:353-381)
- RayIntersectWithAABB2        (ray_math.hpp:398-482, 6-face test)
- RayCastIntersect             (win32_main.cpp:406-556): category order
  spheres -> quads -> planes -> triangles -> aabbs with strict-< updates,
  quads using the hardcoded minHit=0.02 Cornell hack (win32_main.cpp:446),
  miss => hitMatIndex 0 (sky) and hitDistance FLT_MAX.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..scene.schema import (
    F32_MAX, MIN_HIT_DISTANCE, QUAD_MIN_HIT_DISTANCE, Scene, TOLERANCE,
)
from ..utils.vec import Vec3, cross, dot, normalize, where as vwhere


class Hit(NamedTuple):
    """ray_payload_t (ray.hpp:137-141): SoA over the ray batch."""
    t: jnp.ndarray
    mat: jnp.ndarray       # int32
    normal: Vec3


def ray_sphere(
    o: Vec3, d: Vec3, center: Vec3, radius, min_hit: float = MIN_HIT_DISTANCE
) -> Tuple[jnp.ndarray, jnp.ndarray, Vec3]:
    """RaySphereIntersect (win32_main.cpp:2355-2379). Near root only.

    Returns (t, hit, normal); t/normal are meaningful only where hit.
    """
    rel = o - center
    a = dot(d, d)
    b = 2.0 * dot(rel, d)
    c = dot(rel, rel) - radius * radius
    disc = b * b - 4.0 * a * c
    ok = disc >= 0.0
    root = jnp.sqrt(jnp.maximum(disc, 0.0))
    t = (-b - root) / (2.0 * a)
    hit = ok & (root > TOLERANCE) & (t > min_hit)
    n = normalize(d * t + rel, eps=1e-30)
    return t, hit, n


def ray_plane(
    o: Vec3, d: Vec3, n: Vec3, d_coef, min_hit: float = MIN_HIT_DISTANCE
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """RayIntersectPlane (ray_math.hpp:334-341). Returns (t, valid) where
    valid means |denom| > TOLERANCE; the caller applies the t > min_hit test
    exactly as RayCastIntersect does (win32_main.cpp:468)."""
    denom = dot(n, d)
    valid = (denom < -TOLERANCE) | (denom > TOLERANCE)
    t = (d_coef - dot(n, o)) / jnp.where(valid, denom, 1.0)
    return t, valid


def _planar_coords(o: Vec3, d: Vec3, t, A: Vec3, u: Vec3, v: Vec3):
    """alpha/beta parameterization shared by tri/quad (ray_math.hpp:367-372)."""
    n = cross(u, v)
    p = o + d * t - A
    w = n * (1.0 / dot(n, n))
    alpha = dot(w, cross(p, v))
    beta = dot(w, cross(u, p))
    return alpha, beta


def ray_planar_quad(
    o: Vec3, d: Vec3, A: Vec3, u: Vec3, v: Vec3,
    min_hit: float = QUAD_MIN_HIT_DISTANCE,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """RayIntersectPlanarShape<PLANAR_QUAD> (ray_math.hpp:357-381) combined
    with the caller's t > min_hit acceptance (win32_main.cpp:448-451)."""
    n = cross(u, v)
    n_unit = normalize(n, eps=1e-30)
    d_coef = dot(A, n_unit)
    t, valid = ray_plane(o, d, n_unit, d_coef, min_hit)
    alpha, beta = _planar_coords(o, d, t, A, u, v)
    inside = (alpha >= 0.0) & (alpha <= 1.0) & (beta >= 0.0) & (beta <= 1.0)
    hit = valid & inside & (t > min_hit)
    return t, hit


def ray_planar_triangle_uv(
    o: Vec3, d: Vec3, A: Vec3, u: Vec3, v: Vec3,
    min_hit: float = MIN_HIT_DISTANCE,
):
    """ray_planar_triangle + its barycentrics (alpha along u, beta along
    v; hitpoint = A + alpha*u + beta*v), for per-vertex attribute
    interpolation at the winning hit."""
    n = cross(u, v)
    n_unit = normalize(n, eps=1e-30)
    d_coef = dot(A, n_unit)
    t, valid = ray_plane(o, d, n_unit, d_coef, min_hit)
    alpha, beta = _planar_coords(o, d, t, A, u, v)
    inside = (alpha >= 0.0) & (beta >= 0.0) & ((alpha + beta) <= 1.0)
    hit = valid & inside & (t > min_hit)
    return t, hit, alpha, beta


def ray_planar_triangle(
    o: Vec3, d: Vec3, A: Vec3, u: Vec3, v: Vec3,
    min_hit: float = MIN_HIT_DISTANCE,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """RayIntersectPlanarShape<PLANAR_TRIANGLE> (ray_math.hpp:357-381)."""
    t, hit, _, _ = ray_planar_triangle_uv(o, d, A, u, v, min_hit)
    return t, hit


_FACE_NORMALS = (
    (0.0, 0.0, -1.0), (0.0, 0.0, 1.0),
    (-1.0, 0.0, 0.0), (1.0, 0.0, 0.0),
    (0.0, 1.0, 0.0), (0.0, -1.0, 0.0),
)


def ray_aabb_faces(
    o: Vec3, d: Vec3, box_min: Vec3, box_max: Vec3
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """RayIntersectWithAABB2 (ray_math.hpp:398-482): test the 6 faces in
    order front(z-)/back(z+)/left(x-)/right(x+)/top(y+)/bottom(y-); the
    FIRST face whose in-plane hit point lies inside the box (t >= 0,
    inclusive bounds) wins — this temporal-stability rule is part of the
    reference contract. Returns (t, hit, face_idx)."""
    def face(j):
        if j in (0, 1):
            axis_o, axis_d = o.z, d.z
            coord = box_min.z if j == 0 else box_max.z
            p = lambda t: (o.x + d.x * t, o.y + d.y * t, coord)
        elif j in (2, 3):
            axis_o, axis_d = o.x, d.x
            coord = box_min.x if j == 2 else box_max.x
            p = lambda t: (coord, o.y + d.y * t, o.z + d.z * t)
        else:
            axis_o, axis_d = o.y, d.y
            coord = box_max.y if j == 4 else box_min.y
            p = lambda t: (o.x + d.x * t, coord, o.z + d.z * t)
        nonzero = axis_d != 0.0
        t = (coord - axis_o) / jnp.where(nonzero, axis_d, 1.0)
        px, py, pz = p(t)
        inb = (
            (px >= box_min.x) & (px <= box_max.x)
            & (py >= box_min.y) & (py <= box_max.y)
            & (pz >= box_min.z) & (pz <= box_max.z)
        )
        return t, nonzero & (t >= 0.0) & inb

    shape = jnp.shape(o.x)
    best_t = jnp.zeros(shape)
    best_face = jnp.zeros(shape, jnp.int32)
    found = jnp.zeros(shape, bool)
    for j in range(6):
        t, ok = face(j)
        take = ok & ~found
        best_t = jnp.where(take, t, best_t)
        best_face = jnp.where(take, j, best_face)
        found = found | ok
    return best_t, found, best_face


def ray_aabb_hit(o: Vec3, d: Vec3, box_min: Vec3, box_max: Vec3) -> jnp.ndarray:
    """Boolean reject used by octree traversal (RayIntersectsWithAABB,
    win32_main.cpp:394-404). Implemented as a slab test, which is
    boolean-equivalent to the 6-face test (touch-at-t>=0) and far cheaper
    per lane."""
    inv = Vec3(
        1.0 / jnp.where(d.x != 0.0, d.x, 1e-30),
        1.0 / jnp.where(d.y != 0.0, d.y, 1e-30),
        1.0 / jnp.where(d.z != 0.0, d.z, 1e-30),
    )
    t0x = (box_min.x - o.x) * inv.x
    t1x = (box_max.x - o.x) * inv.x
    t0y = (box_min.y - o.y) * inv.y
    t1y = (box_max.y - o.y) * inv.y
    t0z = (box_min.z - o.z) * inv.z
    t1z = (box_max.z - o.z) * inv.z
    tmin = jnp.maximum(jnp.maximum(jnp.minimum(t0x, t1x), jnp.minimum(t0y, t1y)),
                       jnp.minimum(t0z, t1z))
    tmax = jnp.minimum(jnp.minimum(jnp.maximum(t0x, t1x), jnp.maximum(t0y, t1y)),
                       jnp.maximum(t0z, t1z))
    return (tmax >= tmin) & (tmax >= 0.0)


# ---------------------------------------------------------------------------
# Scene-level nearest hit (RayCastIntersect, win32_main.cpp:406-556)
# ---------------------------------------------------------------------------

_UNROLL_MAX = 192  # larger straight-line unrolls blow up compile time
_CHUNK = 16


def _scan_table(n_items, body, init):
    """Loop over a primitive table (static trip count).

    Small tables unroll with python indices: static slices fuse better.
    Large tables use fori_loop to bound code size.
    """
    if n_items == 0:
        return init
    if n_items <= _UNROLL_MAX:
        for i in range(n_items):
            init = body(i, init)
        return init
    return jax.lax.fori_loop(0, n_items, body, init)


def _scan_table_chunked(n_items, tables, body, init):
    """Chunked loop for LARGE primitive tables: one dynamic_slice of _CHUNK
    rows per fori iteration, static indexing within the chunk.

    A per-item fori pays one dynamic-slice load per primitive; full
    unrolling of ~750-item tables explodes compile time. Chunking keeps
    _CHUNK static primitive tests per iteration at 1/_CHUNK the code size.
    ``tables`` is a dict of (P,) arrays (P padded >= n_items);
    ``body(row_scalars: dict, item_valid, h)`` processes one primitive.
    """
    if n_items == 0:
        return init
    if n_items <= _UNROLL_MAX:
        rows = lambda i: {k: v[i] for k, v in tables.items()}
        for i in range(n_items):
            init = body(rows(i), True, init)
        return init
    n_chunks = -(-n_items // _CHUNK)

    def chunk_body(ci, h):
        base = ci * _CHUNK
        sl = {k: jax.lax.dynamic_slice_in_dim(v, base, _CHUNK)
              for k, v in tables.items()}
        for k in range(_CHUNK):
            valid = base + k < n_items
            h = body({key: v[k] for key, v in sl.items()}, valid, h)
        return h

    return jax.lax.fori_loop(0, n_chunks, chunk_body, init)


def intersect_spheres(scene: Scene, o: Vec3, d: Vec3, best: Hit) -> Hit:
    tables = dict(
        cx=scene.sph_center.x, cy=scene.sph_center.y, cz=scene.sph_center.z,
        r=scene.sph_radius, m=scene.sph_mat,
    )

    def body(row, valid, h):
        center = Vec3(row["cx"], row["cy"], row["cz"])
        t, hit, n = ray_sphere(o, d, center, row["r"])
        take = hit & (t < h.t) & valid
        return Hit(
            jnp.where(take, t, h.t),
            jnp.where(take, row["m"], h.mat),
            vwhere(take, n, h.normal),
        )
    return _scan_table_chunked(scene.n_spheres, tables, body, best)


def intersect_quads(scene: Scene, o: Vec3, d: Vec3, best: Hit) -> Hit:
    def body(i, h):
        A = Vec3(scene.quad_point.x[i], scene.quad_point.y[i], scene.quad_point.z[i])
        u = Vec3(scene.quad_u.x[i], scene.quad_u.y[i], scene.quad_u.z[i])
        v = Vec3(scene.quad_v.x[i], scene.quad_v.y[i], scene.quad_v.z[i])
        if scene.quad_n is not None:
            # baked at finalize (schema._bake_quad_normals) — bit-identical
            # to the normalize(cross) this loop used to evaluate per bounce
            n = Vec3(scene.quad_n.x[i], scene.quad_n.y[i], scene.quad_n.z[i])
        else:
            n = normalize(cross(u, v), eps=1e-30)
        t, hit = ray_planar_quad(o, d, A, u, v)
        take = hit & (t < h.t)
        return Hit(
            jnp.where(take, t, h.t),
            jnp.where(take, scene.quad_mat[i], h.mat),
            vwhere(take, n, h.normal),
        )
    return _scan_table(scene.n_quads, body, best)


def intersect_planes(scene: Scene, o: Vec3, d: Vec3, best: Hit) -> Hit:
    def body(i, h):
        n = Vec3(scene.pln_n.x[i], scene.pln_n.y[i], scene.pln_n.z[i])
        t, valid = ray_plane(o, d, n, scene.pln_d[i])
        take = valid & (t > MIN_HIT_DISTANCE) & (t < h.t)
        return Hit(
            jnp.where(take, t, h.t),
            jnp.where(take, scene.pln_mat[i], h.mat),
            vwhere(take, n, h.normal),
        )
    return _scan_table(scene.n_planes, body, best)


def intersect_triangles_brute(scene: Scene, o: Vec3, d: Vec3, best: Hit) -> Hit:
    """Nearest hit over all triangles. Semantically identical to the octree
    traversal (win32_main.cpp:476-526): the octree only prunes work, never
    changes the nearest hit. The default triangle path; the grid DDA
    (ops/traverse.py) is the opt-in alternative."""
    tables = dict(
        ax=scene.tri_a.x, ay=scene.tri_a.y, az=scene.tri_a.z,
        ux=scene.tri_u.x, uy=scene.tri_u.y, uz=scene.tri_u.z,
        vx=scene.tri_v.x, vy=scene.tri_v.y, vz=scene.tri_v.z,
        m=scene.tri_mat,
    )

    def body(row, valid, h):
        A = Vec3(row["ax"], row["ay"], row["az"])
        u = Vec3(row["ux"], row["uy"], row["uz"])
        v = Vec3(row["vx"], row["vy"], row["vz"])
        n = normalize(cross(u, v), eps=1e-30)
        t, hit = ray_planar_triangle(o, d, A, u, v)
        take = hit & (t < h.t) & valid
        return Hit(
            jnp.where(take, t, h.t),
            jnp.where(take, row["m"], h.mat),
            vwhere(take, n, h.normal),
        )
    return _scan_table_chunked(scene.n_tris, tables, body, best)


def intersect_boxes(scene: Scene, o: Vec3, d: Vec3, best: Hit) -> Hit:
    """world->aabbs loop (win32_main.cpp:529-553). Dead in the reference
    (aabbs never populated, win32_main.cpp:2039-2045) but implemented for
    parity; normal comes from the first-hit face."""
    normals = jnp.asarray(_FACE_NORMALS, jnp.float32)

    def body(i, h):
        bmin = Vec3(scene.box_min.x[i], scene.box_min.y[i], scene.box_min.z[i])
        bmax = Vec3(scene.box_max.x[i], scene.box_max.y[i], scene.box_max.z[i])
        t, hit, face = ray_aabb_faces(o, d, bmin, bmax)
        take = hit & (t > MIN_HIT_DISTANCE) & (t < h.t)
        n = Vec3(normals[face, 0], normals[face, 1], normals[face, 2])
        return Hit(
            jnp.where(take, t, h.t),
            jnp.where(take, scene.box_mat[i], h.mat),
            vwhere(take, n, h.normal),
        )
    return _scan_table(scene.n_boxes, body, best)


def intersect_scene(scene: Scene, o: Vec3, d: Vec3) -> Hit:
    """RayCastIntersect (win32_main.cpp:406-556): category order with
    strict-< updates; miss => (FLT_MAX, mat 0, normal (0,0,0))."""
    shape = jnp.shape(o.x)
    best = Hit(
        jnp.full(shape, F32_MAX),
        jnp.zeros(shape, jnp.int32),
        Vec3(jnp.zeros(shape), jnp.zeros(shape), jnp.zeros(shape)),
    )
    best = intersect_spheres(scene, o, d, best)
    best = intersect_quads(scene, o, d, best)
    best = intersect_planes(scene, o, d, best)
    if scene.n_tris:
        if scene.grid_res:
            from .traverse import intersect_triangles_grid
            best = intersect_triangles_grid(scene, o, d, best)
        else:
            best = intersect_triangles_brute(scene, o, d, best)
    best = intersect_boxes(scene, o, d, best)
    return best


def _intersect_triangles_brute_uv(scene: Scene, o: Vec3, d: Vec3, best: Hit):
    """Triangle pass that additionally interpolates the winner's texture
    coordinate IN the loop body (mesh-UV scenes; see intersect_scene_uv):
    uv = uv0 + alpha * (uv1 - uv0) + beta * (uv2 - uv0) — barycentric
    weights (1-a-b, a, b) for vertices (A, B, C) with u = B-A, v = C-A —
    selected at take time. Carrying the interpolated (uvx, uvy) instead
    of (alpha, beta, winner index) costs the same three selects per
    triangle but needs NO per-lane gather afterwards. The hit
    decision graph is ray_planar_triangle's exactly, so t/mat/normal
    match intersect_triangles_brute bit-for-bit."""
    shape = jnp.shape(o.x)
    tables = dict(
        ax=scene.tri_a.x, ay=scene.tri_a.y, az=scene.tri_a.z,
        ux=scene.tri_u.x, uy=scene.tri_u.y, uz=scene.tri_u.z,
        vx=scene.tri_v.x, vy=scene.tri_v.y, vz=scene.tri_v.z,
        m=scene.tri_mat,
        u0=scene.tri_uv0u, v0=scene.tri_uv0v,
        du1=scene.tri_uvdu1, dv1=scene.tri_uvdv1,
        du2=scene.tri_uvdu2, dv2=scene.tri_uvdv2,
    )

    def body(row, valid, carry):
        h, cu, cv, took = carry
        A = Vec3(row["ax"], row["ay"], row["az"])
        u = Vec3(row["ux"], row["uy"], row["uz"])
        v = Vec3(row["vx"], row["vy"], row["vz"])
        n = normalize(cross(u, v), eps=1e-30)
        t, hit, alpha, beta = ray_planar_triangle_uv(o, d, A, u, v)
        take = hit & (t < h.t) & valid
        uvx = row["u0"] + alpha * row["du1"] + beta * row["du2"]
        uvy = row["v0"] + alpha * row["dv1"] + beta * row["dv2"]
        return (
            Hit(jnp.where(take, t, h.t),
                jnp.where(take, row["m"], h.mat),
                vwhere(take, n, h.normal)),
            jnp.where(take, uvx, cu),
            jnp.where(take, uvy, cv),
            jnp.where(take, jnp.int32(1), took),
        )

    init = (best, jnp.zeros(shape), jnp.zeros(shape),
            jnp.zeros(shape, jnp.int32))
    return _scan_table_chunked(scene.n_tris, tables, body, init)


def intersect_scene_uv(scene: Scene, o: Vec3, d: Vec3):
    """intersect_scene for mesh-UV scenes (scene.has_mesh_uvs): returns
    (hit, uvx, uvy, uv_ok) where (uvx, uvy) is the per-vertex-interpolated
    texture coordinate of the winning triangle and uv_ok marks lanes whose
    winner IS a triangle (triangles are the last live category —
    world->aabbs is never populated, win32_main.cpp:2039-2045, and this
    path asserts it). The UV interpolation rides the triangle loop itself
    (see _intersect_triangles_brute_uv), so nothing here gathers per
    lane."""
    assert scene.n_boxes == 0, "mesh-UV path assumes the dead aabbs table"
    shape = jnp.shape(o.x)
    best = Hit(
        jnp.full(shape, F32_MAX),
        jnp.zeros(shape, jnp.int32),
        Vec3(jnp.zeros(shape), jnp.zeros(shape), jnp.zeros(shape)),
    )
    best = intersect_spheres(scene, o, d, best)
    best = intersect_quads(scene, o, d, best)
    best = intersect_planes(scene, o, d, best)
    best, uvx, uvy, took = _intersect_triangles_brute_uv(scene, o, d, best)
    return best, uvx, uvy, took != 0
