"""Tangent-frame normal mapping (Scene.tbn_normal_maps / --tbn): the
reference's "support normal maps applied to surface where the normal is
not pointing directly up" TODO (win32_main.cpp:175). Default OFF =
world-space replacement parity (:642)."""

import numpy as np

from pathtracer_tpu.render.renderer import RenderConfig, render_image
from pathtracer_tpu.reference.cpu_oracle import render_oracle
from pathtracer_tpu.scene.camera import define_camera
from pathtracer_tpu.scene.schema import WorldBuilder


def _tilted_world(normal_tex):
    """A tilted plane with a normal map, lit by a sphere light + sky."""
    b = WorldBuilder()
    b.add_material(emit=(0.25, 0.3, 0.4))
    light = b.add_material(emit=(7.0, 6.5, 6.0))
    b.add_sphere((4.0, -4.0, 8.0), 1.0, light)
    m = b.add_material(albedo=(0.6, 0.5, 0.4), roughness=0.7, normal_idx=1)
    # plane with normal tilted 45 degrees off up — the case the reference's
    # world-space replacement gets wrong
    n = (0.0, -np.sin(np.pi / 4), np.cos(np.pi / 4))
    b.add_plane(n, 1.0, m)
    b.textures.append(normal_tex.astype(np.float32))
    return b


def _render(b, tbn, w=16, h=10, pp=2, seed=4):
    b.tbn_normal_maps = tbn
    scene = b.finalize()
    assert scene.tbn_normal_maps == tbn
    cam = define_camera((0, -9, 3.0), (0, 0, 0), 35.0, w, h)
    cfg = RenderConfig(width=w, height=h, pp=pp, seed=seed)
    img, _, _ = render_image(scene, cam, cfg)
    return np.asarray(img), cam


class TestTBN:
    def test_identity_map_preserves_geometry(self):
        """A flat (0.5, 0.5, 1) normal map under TBN decodes to ~ +z in
        tangent space and must reproduce the unmapped surface normal on a
        TILTED plane (up to 8-bit texel quantization), i.e. match the
        maps-disabled render closely — where the reference's world-space
        replacement would bend every normal to straight up."""
        flat = np.tile(np.array([0.5, 0.5, 1.0], np.float32), (8, 8, 1))
        b = _tilted_world(flat)
        img_tbn, _ = _render(b, tbn=True)
        b2 = _tilted_world(flat)
        b2.tbn_normal_maps = True
        scene_off = b2.finalize().replace(use_normal_maps=False)
        cam = define_camera((0, -9, 3.0), (0, 0, 0), 35.0, 16, 10)
        cfg = RenderConfig(width=16, height=10, pp=2, seed=4)
        img_off, _, _ = render_image(scene_off, cam, cfg)
        d = np.abs(img_tbn - np.asarray(img_off)).max(axis=-1)
        # 8-bit quantization tilts the decoded normal by ~0.2 deg
        assert np.median(d) < 0.02, float(np.median(d))
        # while world-space replacement is a ~45 deg error:
        img_ws, _ = _render(_tilted_world(flat), tbn=False)
        assert np.abs(img_ws - img_tbn).max() > 0.05

    def test_bumpy_map_matches_oracle(self):
        """Golden: a high-frequency normal map on the tilted plane, TBN
        on, against the scalar oracle twin."""
        rng = np.random.RandomState(8)
        bump = np.stack([
            0.5 + 0.3 * rng.rand(8, 8),
            0.5 + 0.3 * rng.rand(8, 8),
            np.full((8, 8), 0.9),
        ], -1).astype(np.float32)
        b = _tilted_world(bump)
        w, h, pp, seed = 16, 10, 2, 4
        img, cam = _render(b, tbn=True, w=w, h=h, pp=pp, seed=seed)
        oracle = render_oracle(b, cam, w, h, pp, seed=seed, world_kind=0)
        d = np.abs(img - oracle).max(axis=-1)
        assert np.median(d) < 1e-4, float(np.median(d))
        assert (d > 1e-2).mean() < 0.05, float((d > 1e-2).mean())

    def test_wavefront_matches_unrolled_tbn(self):
        """TBN normal-mapped tilted plane through both drivers: the
        normal-map fetch and the tangent-frame rotation are shared code,
        so the images agree up to fma-contraction rounding."""
        rng = np.random.RandomState(5)
        tex = rng.rand(16, 16, 3).astype(np.float32) * 0.4 + 0.3
        tex[..., 2] = 0.8 + 0.2 * tex[..., 2]
        tex = (np.round(tex * 255.0) / 255.0).astype(np.float32)
        b = _tilted_world(tex)
        b.tbn_normal_maps = True
        scene = b.finalize()
        w, h = 16, 10
        cam = define_camera((0, -9, 3.0), (0, 0, 0), 35.0, w, h)
        imgs = []
        for mode in ("unrolled", "wavefront"):
            cfg = RenderConfig(width=w, height=h, pp=2, seed=4, mode=mode)
            imgs.append(np.asarray(render_image(scene, cam, cfg)[0]))
        d = np.abs(imgs[0] - imgs[1]).max(axis=-1)
        assert np.median(d) < 1e-6, float(np.median(d))
        assert (d > 1e-2).mean() < 0.02, float((d > 1e-2).mean())
