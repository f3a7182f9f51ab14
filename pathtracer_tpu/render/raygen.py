"""Camera ray generation: stratified pinhole and thin-lens (depth of field).

Batched equivalents of the per-pixel loops in RenderTexel:
- pinhole: g_pp x g_pp stratified jittered sub-pixel grid
  (win32_main.cpp:1032-1074), including the reference's exact stratum
  arithmetic (film coordinates live in a space stretched by 2, so
  halfFilmPixelW = 1/width and the stratum step is halfFilmPixelW*2/g_pp);
- thin lens: focal-plane construction via 1/f = 1/v + 1/b with
  FIXED_FOCAL_LENGTH (win32_main.cpp:1087-1169) and the 12-entry
  Poisson-disk aperture table indexed by (rayIndex2 * rayIndex) % 12 —
  deterministic, preserved exactly.

One call generates the rays of ONE sample index for ALL pixels (the sample
loop lives in the renderer); that keeps ray state at O(pixels) in HBM and
makes every sample an identical SPMD step.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from ..scene.camera import Camera
from ..scene.schema import FIXED_FOCAL_LENGTH
from ..utils.vec import Vec3, normalize, splat

# The Poisson-disk aperture samples (win32_main.cpp:1097-1110).
POISSON_DISK = (
    (0.0, 0.0),
    (-0.94201624, -0.39906216),
    (0.94558609, -0.76890725),
    (-0.094184101, -0.92938870),
    (0.34495938, 0.29387760),
    (-0.91588581, 0.45771432),
    (-0.81544232, -0.87912464),
    (-0.38277543, 0.27676845),
    (0.97484398, 0.75648379),
    (0.44323325, -0.97511554),
    (0.53742981, -0.47373420),
    (-0.26496911, -0.41893023),
)
NUM_POISSON = len(POISSON_DISK)


def pixel_frustum_coords(width: int, height: int, pixel_idx=None):
    """Per-pixel frustum coords in [-1,1] (win32_main.cpp:1000-1006) for a
    flat y-major pixel index array (defaults to the whole image). Taking
    explicit indices lets a device shard generate exactly its own pixels —
    randomness and geometry are pure functions of the linear pixel index, so
    any tiling/sharding produces identical images."""
    if pixel_idx is None:
        pixel_idx = jnp.arange(width * height, dtype=jnp.int32)
    y = (pixel_idx // width).astype(jnp.float32)
    x = (pixel_idx % width).astype(jnp.float32)
    fy = -1.0 + 2.0 * y / height
    fx = -1.0 + 2.0 * x / width
    return fx, fy


def _film_point(camera: Camera, x_step: jnp.ndarray, y_step: jnp.ndarray) -> Vec3:
    """frustrumP = frustrumCenter + xStep*halfFilmWidth*axisX
    + yStep*halfFilmHeight*axisY (win32_main.cpp:1059-1061)."""
    cx, cy, cz = camera.frustum_center
    ax, ay = camera.axis_x, camera.axis_y
    sx = x_step * camera.half_film_width
    sy = y_step * camera.half_film_height
    return Vec3(
        cx + sx * ax[0] + sy * ay[0],
        cy + sx * ax[1] + sy * ay[1],
        cz + sx * ax[2] + sy * ay[2],
    )


def pinhole_rays(
    camera: Camera,
    width: int,
    height: int,
    pp: int,
    i,
    j,
    jitter_u,  # tuple of two (N,) uniform arrays
    pixel_idx=None,
) -> Tuple[Vec3, Vec3]:
    """Rays for stratum (i, j) of the g_pp x g_pp grid, for the given pixel
    indices (win32_main.cpp:1041-1064). ``i``/``j`` may be traced scalars."""
    fX, fY = pixel_frustum_coords(width, height, pixel_idx)
    hpw, hph = camera.half_film_pixel_w, camera.half_film_pixel_h

    step_x = (1.0 / pp) * hpw * 2.0
    step_y = (1.0 / pp) * hph * 2.0
    i = jnp.asarray(i, jnp.float32)
    j = jnp.asarray(j, jnp.float32)
    x_step = (fX - hpw) + (i / pp) * hpw + 0.5 * step_x + (jitter_u[0] - 0.5) * step_x
    y_step = (fY - hph) + (j / pp) * hph + 0.5 * step_y + (jitter_u[1] - 0.5) * step_y

    p = _film_point(camera, x_step, y_step)
    pin = splat(camera.pos, jnp.shape(fX))
    d = normalize(p - pin)
    return pin, d


def thin_lens_rays(
    camera: Camera,
    width: int,
    height: int,
    pp: int,
    ray_index,
    ray_index2,
    lens_u,  # tuple of two (N,) uniform arrays keyed on (pixel, ray_index)
    pixel_idx=None,
) -> Tuple[Vec3, Vec3]:
    """Thin-lens rays for (rayIndex, rayIndex2) for the given pixel indices
    (win32_main.cpp:1087-1169)."""
    fX, fY = pixel_frustum_coords(width, height, pixel_idx)

    off_x = fX + (2.0 * lens_u[0] - 1.0) * camera.half_film_pixel_w
    off_y = fY + (2.0 * lens_u[1] - 1.0) * camera.half_film_pixel_h
    p = _film_point(camera, off_x, off_y)
    lens_center = splat(camera.pos, jnp.shape(fX))
    ray_dir = normalize(p - lens_center)

    # focal plane: 1/f = 1/v + 1/b (win32_main.cpp:1130-1142)
    focal_plane_dist = 1.0 / (1.0 / FIXED_FOCAL_LENGTH - 1.0 / camera.focal_length)
    az = camera.axis_z
    ax = camera.axis_x
    n = (-az[0], -az[1], -az[2])
    plane_point = (
        camera.pos[0] + ax[0] + focal_plane_dist * n[0],
        camera.pos[1] + ax[1] + focal_plane_dist * n[1],
        camera.pos[2] + ax[2] + focal_plane_dist * n[2],
    )
    d_coef = n[0] * plane_point[0] + n[1] * plane_point[1] + n[2] * plane_point[2]
    denom = n[0] * ray_dir.x + n[1] * ray_dir.y + n[2] * ray_dir.z
    t = (d_coef - (n[0] * lens_center.x + n[1] * lens_center.y + n[2] * lens_center.z)) / denom
    focal_point = lens_center + ray_dir * t

    # Poisson-disk aperture point: disk[(rayIndex2 * rayIndex) % 12].
    # Select-sweep over the 12-entry table instead of a gather: twelve
    # selects on values already in registers.
    idx = (jnp.asarray(ray_index2) * jnp.asarray(ray_index)) % NUM_POISSON
    dx = jnp.zeros_like(jnp.asarray(idx, jnp.float32))
    dy = jnp.zeros_like(dx)
    for k, (px, py) in enumerate(POISSON_DISK):
        take = idx == k
        dx = jnp.where(take, px, dx)
        dy = jnp.where(take, py, dy)
    dx = dx * camera.aperture_radius
    dy = dy * camera.aperture_radius
    axv, ayv = camera.axis_x, camera.axis_y
    o = Vec3(
        lens_center.x + dx * axv[0] + dy * ayv[0],
        lens_center.y + dx * axv[1] + dy * ayv[1],
        lens_center.z + dx * axv[2] + dy * ayv[2],
    )
    d = normalize(focal_point - o)
    return o, d
