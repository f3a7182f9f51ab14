"""The five built-in worlds (LoadWorld, reference win32_main.cpp:1788-2074).

Each builder reproduces the reference scene *data* exactly — material order
(sky always material 0), sphere order (spheres[0] is the NEE light), camera
parameters, and scalar defaults. World 4's layout is random; the reference
seeds a Mersenne-Twister from the OS so it differs per-run — we use a fixed
numpy seed instead so renders are reproducible.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from .camera import Camera, define_camera
from .schema import (
    Scene, WorldBuilder,
    WORLD_DEFAULT, WORLD_BRDF_TEST, WORLD_CORNELL_BOX,
    WORLD_RAYTRACING_ONE_WEEKEND, WORLD_MARIO, WORLD_CORNELL_QUAD,
    WORLD_MESH_UV, WORLD_KIND_COUNT,
)
from . import textures as tex_mod


@dataclasses.dataclass
class CameraParams:
    """The 'user set' camera fields before DefineCamera (win32_main.cpp:1801-1806)."""
    pos: tuple = (0.0, -10.0, 1.0)
    target: tuple = (0.0, 0.0, 0.0)
    fov: float = 45.0
    focal_distance: float = 5.0
    aperture_radius: float = 0.035
    use_pinhole: bool = True


def _add_sky(b: WorldBuilder, color) -> int:
    """AddSky (win32_main.cpp:2048-2051): emissive material at index 0."""
    return b.add_material(emit=tuple(color))


def _add_sun(b: WorldBuilder):
    """AddSunDirectionalLight (win32_main.cpp:2053-2067): emissive sphere at
    (2000,2000,2000) r=1000, emit 15 — pushed FIRST so it is spheres[0],
    the hardcoded important light (win32_main.cpp:683)."""
    light = b.add_material(albedo=(0, 0, 0), emit=(15.0, 15.0, 15.0))
    b.add_sphere((2000.0, 2000.0, 2000.0), 1000.0, light)


def _ground_plane(b: WorldBuilder, mat: int):
    """MakeGroundPlane (win32_main.cpp:2069-2074): n=(0,0,1), d=0."""
    b.add_plane((0.0, 0.0, 1.0), 0.0, mat)


def _uv_sphere_mesh(center, radius, n_seg: int = 32, n_ring: int = 24):
    """Deterministic UV-sphere triangle soup with per-vertex [0,1]^2
    texcoords (longitude, colatitude). Pole rows emit single triangles
    (the collapsed quad edge would make degenerate triangles). 1472
    tris at the default resolution: world 7 is the triangle-heavy world
    with UV-textured shading."""
    cs = np.asarray(center, np.float32)
    th = np.linspace(0.0, np.pi, n_ring + 1)
    ph = np.linspace(0.0, 2.0 * np.pi, n_seg + 1)
    T, P = np.meshgrid(th, ph, indexing="ij")
    V = (np.stack([np.sin(T) * np.cos(P), np.sin(T) * np.sin(P),
                   np.cos(T)], -1) * radius + cs).astype(np.float32)
    UV = np.stack([P / (2.0 * np.pi), T / np.pi], -1).astype(np.float32)
    pts, uvs = [], []
    for i in range(n_ring):
        for j in range(n_seg):
            quad = [(i, j), (i, j + 1), (i + 1, j + 1), (i + 1, j)]
            a, bq, c, dq = quad
            # winding chosen so cross(B-A, C-A) points radially OUTWARD:
            # the estimator kills back-face hits (NdotV <= 0,
            # win32_main.cpp:600-606), so inward normals render black
            if i > 0:  # top pole row: a == b
                for k in (a, c, bq):
                    pts.append(V[k])
                    uvs.append(UV[k])
            if i < n_ring - 1:  # bottom pole row: c == d
                for k in (a, dq, c):
                    pts.append(V[k])
                    uvs.append(UV[k])
    return np.asarray(pts, np.float32), np.asarray(uvs, np.float32)


def _mesh_uv_demo_texture(n: int = 64):
    """Procedural pow2 texture on the 8-bit grid (schema packs RGB8; the
    oracle bit-matches only 8-bit-grid texels, textures.quantize8 class):
    a checker with color gradients so both tiling and interpolation are
    visible."""
    yy, xx = (np.indices((n, n)).astype(np.float32) + 0.5) / n
    checker = ((xx * 8).astype(np.int32) + (yy * 8).astype(np.int32)) % 2
    r = 0.2 + 0.6 * checker
    g = 0.25 + 0.6 * yy
    bch = 0.85 - 0.55 * xx
    t = np.stack([r, g, bch], -1).astype(np.float32)
    return (np.round(t * 255.0) / 255.0).astype(np.float32)


def build_world(
    kind: int,
    use_pinhole: bool = True,
    use_normal_maps: bool = True,
    use_metalness_maps: bool = True,
    use_roughness_maps: bool = True,
    rtiow_seed: int = 1337,
    res_dir: str = tex_mod.REFERENCE_RES_DIR,
) -> Tuple[WorldBuilder, CameraParams]:
    """LoadWorld (win32_main.cpp:1788-2046). Returns the host builder and the
    pre-derivation camera params; call :func:`finalize_world` to get device
    Scene + derived Camera."""
    if not (0 <= kind < WORLD_KIND_COUNT):
        raise ValueError(f"world kind {kind} out of range")

    b = WorldBuilder()
    cam = CameraParams(use_pinhole=use_pinhole)

    if kind == WORLD_DEFAULT:
        # win32_main.cpp:1809-1842
        _add_sky(b, (65 / 255.0, 108 / 255.0, 162 / 255.0))
        _add_sun(b)

        plane_mat = b.add_material(
            albedo_idx=1, metalness_idx=2,
            metal_color=(0.562, 0.565, 0.578),
            roughness_idx=3, normal_idx=4,
        )
        b.add_sphere((0.0, 0.0, -1000.0), 1000.0, plane_mat)  # textured ground sphere

        for t in tex_mod.load_bespoke_textures(res_dir):
            b.add_texture(t)

        m = b.add_material(albedo=(0.7, 0.25, 0.3), roughness=0.0)
        b.add_sphere((0.0, 0.0, 0.0), 1.0, m)
        m = b.add_material(albedo=(0.0, 0.8, 0.0), metalness=0.8,
                           metal_color=(0.562, 0.565, 0.578), roughness=0.0)
        b.add_sphere((-2.0, 0.0, 2.0), 1.0, m)
        m = b.add_material(albedo=(0.3, 0.25, 0.7), roughness=0.0)
        b.add_sphere((-1.0, -5.0, 0.0), 1.0, m)

        cam.fov = 30.0

    elif kind == WORLD_CORNELL_BOX:
        # win32_main.cpp:1844-1901
        _add_sky(b, (0.0, 0.0, 0.0))
        left, right, bottom, top, front, back = 0.0, 800.0, 0.0, 555.0, 0.0, 555.0
        red = b.add_material(albedo=(0.65, 0.05, 0.05))
        white = b.add_material(albedo=(0.73, 0.73, 0.73))
        green = b.add_material(albedo=(0.12, 0.45, 0.15))
        light = b.add_material(albedo=(0, 0, 0), emit=(15.0, 15.0, 15.0))

        # right wall (Z cross Y = -X)
        b.add_quad((right, bottom, front), (0, 0, top - bottom), (0, back - front, 0), green)
        # left wall (Y cross Z = X)
        b.add_quad((left, bottom, front), (0, back - front, 0), (0, 0, top - bottom), red)
        # light sphere — spheres[0], the NEE target
        b.add_sphere(((right - left) / 2.0, (back - front) / 2.0, (top - bottom) / 2.0), 65.0, light)
        # ceiling
        b.add_quad((left, front, top), (0, back - front, 0), (right - left, 0, 0), white)
        # back wall
        b.add_quad((left, back, bottom), (right - left, 0, 0), (0, 0, top - bottom), white)
        # floor
        b.add_quad((left, bottom, front), (right - left, 0, 0), (0, back - front, 0), white)

        cam.fov = 40.0
        cam.pos = ((right - left) / 2.0, front - 800.0, (top - bottom) / 2.0)
        cam.target = ((right - left) / 2.0, front, (top - bottom) / 2.0)

    elif kind == WORLD_CORNELL_QUAD:
        # Our sixth world (beyond the reference's five, -w6): the Cornell
        # box rebuilt around an emissive AREA QUAD in the ceiling — the
        # scene the reference's dead PdfValueQuad (win32_main.cpp:301-322)
        # was written for. Geometry/material data follow the reference's
        # Cornell (:1844-1901); the light sphere is replaced by a 260x260
        # quad just under the ceiling plus two spheres so the soft
        # shadows show.
        _add_sky(b, (0.0, 0.0, 0.0))
        left, right, bottom, top, front, back = 0.0, 800.0, 0.0, 555.0, 0.0, 555.0
        red = b.add_material(albedo=(0.65, 0.05, 0.05))
        white = b.add_material(albedo=(0.73, 0.73, 0.73))
        green = b.add_material(albedo=(0.12, 0.45, 0.15))
        # emit tuned so the quad lights the 800-wide box to the same mean
        # linear radiance as world 3 (~0.2); the classic Cornell's 15 is
        # calibrated to its much larger light-to-box ratio. A 260x260 quad
        # at emit 10 carries the same power as 130x130 at 40 with 4x lower
        # per-hit weight (fewer fireflies, softer shadows).
        light = b.add_material(albedo=(0, 0, 0), emit=(10.0, 10.0, 10.0))

        b.add_quad((right, bottom, front), (0, 0, top - bottom), (0, back - front, 0), green)
        b.add_quad((left, bottom, front), (0, back - front, 0), (0, 0, top - bottom), red)
        # the area light: spheres stay empty of emitters; NEE targets this
        cx, cy = (right - left) / 2.0, (back - front) / 2.0
        ql = b.add_quad((cx - 130.0, cy - 130.0, top - 1.0),
                        (260.0, 0.0, 0.0), (0.0, 260.0, 0.0), light)
        b.set_quad_light(ql)
        b.add_quad((left, front, top), (0, back - front, 0), (right - left, 0, 0), white)
        b.add_quad((left, back, bottom), (right - left, 0, 0), (0, 0, top - bottom), white)
        b.add_quad((left, bottom, front), (right - left, 0, 0), (0, back - front, 0), white)

        m = b.add_material(albedo=(0.73, 0.73, 0.73), roughness=1.0)
        b.add_sphere((cx - 150.0, cy + 60.0, 110.0), 110.0, m)
        m = b.add_material(metalness=0.9, metal_color=(0.8, 0.75, 0.6),
                           roughness=0.15)
        b.add_sphere((cx + 160.0, cy - 80.0, 90.0), 90.0, m)

        cam.fov = 40.0
        cam.pos = (cx, front - 800.0, (top - bottom) / 2.0)
        cam.target = (cx, front, (top - bottom) / 2.0)

    elif kind == WORLD_BRDF_TEST:
        # win32_main.cpp:1903-1928 — 11x11 metal/roughness sweep
        _add_sky(b, (65 / 255.0, 108 / 255.0, 162 / 255.0))
        _add_sun(b)
        plane_mat = b.add_material(albedo=(0.5, 0.5, 0.5))
        _ground_plane(b, plane_mat)
        color = (1.0, 0.782, 0.344)
        for i in range(11):
            for j in range(11):
                m = b.add_material(albedo=color, metalness=i / 10.0,
                                   metal_color=color, roughness=j / 10.0)
                b.add_sphere((i / 2.0, 11 / 2.0 - j / 2.0, 0.2), 0.2, m)
        cam.target = (2.5, 2.5, 0.0)
        cam.pos = (2.5, 7.0, 2.0)
        cam.fov = 50.0
        cam.focal_distance = 10.0

    elif kind == WORLD_MARIO:
        # win32_main.cpp:1930-1958 — GLTF mesh + ground plane
        _add_sky(b, (65 / 255.0, 108 / 255.0, 162 / 255.0))
        _add_sun(b)
        plane_mat = b.add_material(albedo=(0.5, 0.5, 0.5))
        _ground_plane(b, plane_mat)

        from .gltf import load_glb_triangles
        points, mat_indices = load_glb_triangles(
            res_dir + "/mario.glb", b)
        if points is not None:
            b.set_mesh(points, mat_indices)

        cam.target = (0.0, 0.0, 1.0)
        cam.pos = (-5.0, -5.0, 1.0)
        cam.fov = 30.0

    elif kind == WORLD_MESH_UV:
        # Our seventh world (-w7, beyond the reference's five): the
        # mesh-UV textured-materials path (the reference's "load
        # materials with textures" TODO, win32_main.cpp:172) as a
        # first-class benchable scene — a procedurally UV-mapped sphere
        # mesh (1472 tris) wearing a generated pow2 checker, on the
        # reference ground plane, lit by an emissive sphere (spheres[0] =
        # the NEE target, :683). Asset-free and deterministic so goldens,
        # bench --world 7 and chip_smoke.py can all cover it.
        _add_sky(b, (0.35, 0.45, 0.6))
        light = b.add_material(albedo=(0, 0, 0), emit=(10.0, 9.5, 9.0))
        b.add_sphere((5.0, -4.0, 7.0), 1.2, light)
        mt = b.add_material(albedo=(1.0, 1.0, 1.0), roughness=0.55,
                            albedo_idx=b.add_texture(_mesh_uv_demo_texture()))
        pts, uvs = _uv_sphere_mesh((0.0, 0.0, 1.4), 1.4)
        b.set_mesh(pts, np.full((len(pts),), mt, np.int32), uvs=uvs)
        floor = b.add_material(albedo=(0.55, 0.5, 0.45), roughness=0.9)
        _ground_plane(b, floor)

        cam.pos = (0.0, -7.0, 2.2)
        cam.target = (0.0, 0.0, 1.3)
        cam.fov = 32.0

    elif kind == WORLD_RAYTRACING_ONE_WEEKEND:
        # win32_main.cpp:1960-2035 — RTIOW book cover.
        _add_sky(b, (1.0, 1.0, 1.0))
        ground = b.add_material(albedo=(0.5, 0.5, 0.5))
        b.add_sphere((0.0, 0.0, -1000.0), 1000.0, ground)

        rng = np.random.RandomState(rtiow_seed)

        def rand():
            return float(rng.rand())

        def rand_v3():
            return (rand(), rand(), rand())

        for a in range(-11, 11):
            for bb in range(-11, 11):
                choose = rand()
                center = (a + 0.9 * rand(), bb + 0.9 * rand(), 0.2)
                d = np.array(center) - np.array((4.0, 0.0, 0.2))
                if float(np.sqrt((d * d).sum())) > 0.9:
                    if choose < 0.8:
                        c1, c2 = rand_v3(), rand_v3()
                        m = b.add_material(albedo=tuple(x * y for x, y in zip(c1, c2)))
                    else:
                        # NOTE: the reference's ".roughness = 1-material.metalness"
                        # reads the PREVIOUS value of the material variable
                        # (win32_main.cpp:1991-1994, C++ assignment-from-init-list
                        # evaluates the RHS before the store). Its scene is
                        # OS-seeded random so no image can match anyway; we keep
                        # the clear intent: roughness = 1 - (new) metalness.
                        metalness = rand()
                        mc = rand_v3()
                        m = b.add_material(
                            metalness=metalness,
                            metal_color=(0.5 * mc[0] + 0.5, 0.5 * mc[1] + 0.5, 0.5 * mc[2] + 0.5),
                            roughness=1.0 - metalness,
                        )
                    b.add_sphere(center, 0.2, m)

        m2 = b.add_material(albedo=(0.4, 0.2, 0.1))
        b.add_sphere((-4.0, 0.0, 1.0), 1.0, m2)
        m3 = b.add_material(metalness=1.0, metal_color=(0.7, 0.6, 0.5), roughness=0.0)
        b.add_sphere((4.0, 0.0, 1.0), 1.0, m3)

        cam.use_pinhole = False  # forced thin-lens (win32_main.cpp:2030)
        cam.target = (0.0, 0.0, 0.0)
        cam.pos = (13.0, 3.0, 2.0)
        cam.fov = 20.0
        cam.focal_distance = 10.0

    return b, cam


def finalize_world(
    kind: int,
    image_width: int,
    image_height: int,
    use_pinhole: bool = True,
    use_normal_maps: bool = True,
    use_metalness_maps: bool = True,
    use_roughness_maps: bool = True,
    rtiow_seed: int = 1337,
    res_dir: str = tex_mod.REFERENCE_RES_DIR,
    use_grid: bool = False,
) -> Tuple[Scene, Camera]:
    """Build world ``kind`` and derive the camera for the given image size.

    ``use_grid`` selects the uniform-grid DDA traversal for triangles
    (results identical to brute force — tested in test_accel.py). Default
    OFF: chunked brute force is the measured-simpler path at reference
    mesh sizes; whether the grid or a BVH wins on the GPU is not measured
    yet.
    """
    b, cam = build_world(
        kind,
        use_pinhole=use_pinhole,
        use_normal_maps=use_normal_maps,
        use_metalness_maps=use_metalness_maps,
        use_roughness_maps=use_roughness_maps,
        rtiow_seed=rtiow_seed,
        res_dir=res_dir,
    )
    grid = None
    if use_grid and b.triangles is not None and len(b.triangles):
        from .accel import build_uniform_grid
        grid = build_uniform_grid(b.triangles)
    scene = b.finalize(
        world_kind=kind,
        use_normal_maps=use_normal_maps,
        use_metalness_maps=use_metalness_maps,
        use_roughness_maps=use_roughness_maps,
        grid=grid,
    )
    camera = define_camera(
        cam.pos, cam.target, cam.fov, image_width, image_height,
        use_pinhole=cam.use_pinhole,
        focal_distance=cam.focal_distance,
        aperture_radius=cam.aperture_radius,
    )
    return scene, camera
