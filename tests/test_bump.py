"""Bump (height) maps — the reference's unrealized "bump map" TODO
(win32_main.cpp:173): gradient-tilted normals in the bespoke planar
frame, oracle-twinned."""

import numpy as np

import jax.numpy as jnp

from pathtracer_tpu.ops.intersect import Hit
from pathtracer_tpu.render.integrator import shade_bounce
from pathtracer_tpu.render.renderer import RenderConfig, render_image
from pathtracer_tpu.reference.cpu_oracle import render_oracle
from pathtracer_tpu.scene.camera import define_camera
from pathtracer_tpu.scene.schema import WorldBuilder
from pathtracer_tpu.utils.vec import Vec3


def _bumpy_world(tex):
    b = WorldBuilder()
    b.add_material(emit=(0.3, 0.35, 0.45))
    light = b.add_material(emit=(6.0, 5.5, 5.0))
    b.add_sphere((3, -3, 6), 1.0, light)
    ti = b.add_texture(tex)
    m = b.add_material(albedo=(0.6, 0.5, 0.4), roughness=0.8,
                       bump_idx=ti, bump_scale=0.5)
    b.add_plane((0, 0, 1), 0.0, m)
    return b


class TestBump:
    def test_flat_height_leaves_normal(self):
        """A constant height map has zero gradient: the shading normal
        stays the geometric one (checked via primary-ray normals on the
        ground plane)."""
        flat = np.full((8, 8, 3), 0.5, np.float32)
        scene = _bumpy_world(flat).finalize()
        assert scene.any_bump
        o = Vec3(*(jnp.asarray([v], jnp.float32) for v in (0.0, 0.0, 2.0)))
        d = Vec3(*(jnp.asarray([v], jnp.float32) for v in (0.0, 0.0, -1.0)))
        hit = Hit(jnp.asarray([2.0], jnp.float32),
                  jnp.asarray([2], jnp.int32),
                  Vec3(*(jnp.asarray([v], jnp.float32)
                         for v in (0.0, 0.0, 1.0))))
        u = tuple(jnp.asarray([v], jnp.float32)
                  for v in (0.2, 0.2, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5))
        out = shade_bounce(scene, o, d, hit, u)
        n = [float(np.asarray(c)[0]) for c in
             (out.shading_normal.x, out.shading_normal.y,
              out.shading_normal.z)]
        np.testing.assert_allclose(n, (0.0, 0.0, 1.0), atol=1e-6)

    def test_ramp_tilts_against_gradient(self):
        """height rising along +x must tilt the normal toward -x
        (heightfield normal ~ (-dh/dx, -dh/dy, 1))."""
        ramp = np.tile(np.linspace(0.0, 1.0, 64, dtype=np.float32)[None, :, None],
                       (64, 1, 3))
        scene = _bumpy_world(ramp).finalize()
        o = Vec3(*(jnp.asarray([v], jnp.float32) for v in (0.1, 0.1, 2.0)))
        d = Vec3(*(jnp.asarray([v], jnp.float32) for v in (0.0, 0.0, -1.0)))
        hit = Hit(jnp.asarray([2.0], jnp.float32),
                  jnp.asarray([2], jnp.int32),
                  Vec3(*(jnp.asarray([v], jnp.float32)
                         for v in (0.0, 0.0, 1.0))))
        u = tuple(jnp.asarray([v], jnp.float32)
                  for v in (0.2, 0.2, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5))
        out = shade_bounce(scene, o, d, hit, u)
        nx = float(np.asarray(out.shading_normal.x)[0])
        nz = float(np.asarray(out.shading_normal.z)[0])
        assert nx < -0.01 and nz > 0.5, (nx, nz)

    def test_bumpy_floor_matches_oracle(self):
        rng = np.random.RandomState(12)
        tex = np.repeat(rng.rand(16, 16, 1), 3, axis=2).astype(np.float32)
        tex = np.round(tex * 255.0) / 255.0  # 8-bit grid (device packing)
        b = _bumpy_world(tex.astype(np.float32))
        w, h, pp = 16, 12, 2
        cam = define_camera((0, -8, 2), (0, 0, 0), 35.0, w, h)
        scene = b.finalize()
        cfg = RenderConfig(width=w, height=h, pp=pp, seed=6)
        img, _, _ = render_image(scene, cam, cfg)
        oracle = render_oracle(b, cam, w, h, pp, seed=6, world_kind=0)
        img = np.asarray(img)
        d = np.abs(img - oracle).max(axis=-1)
        assert np.median(d) < 1e-4, float(np.median(d))
        assert (d > 1e-2).mean() < 0.05, float((d > 1e-2).mean())

    def test_wavefront_matches_unrolled(self):
        """The bumpy floor through both drivers: the three height fetches
        and the tilt are shared code (shade_bounce), and randomness is a
        function of (pixel, sample, bounce), so the images agree; the two
        programs may contract fma differently, so gate at rounding
        scale."""
        rng = np.random.RandomState(12)
        tex = np.repeat(rng.rand(16, 16, 1), 3, axis=2).astype(np.float32)
        tex = (np.round(tex * 255.0) / 255.0).astype(np.float32)
        scene = _bumpy_world(tex).finalize()
        w, h = 16, 12
        cam = define_camera((0, -8, 2), (0, 0, 0), 35.0, w, h)
        imgs = []
        for mode in ("unrolled", "wavefront"):
            cfg = RenderConfig(width=w, height=h, pp=2, seed=6, mode=mode)
            imgs.append(np.asarray(render_image(scene, cam, cfg)[0]))
        d = np.abs(imgs[0] - imgs[1]).max(axis=-1)
        assert np.median(d) < 1e-6, float(np.median(d))
        assert (d > 1e-2).mean() < 0.02, float((d > 1e-2).mean())
