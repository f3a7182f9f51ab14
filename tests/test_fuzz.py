"""Property-based golden tests: random scenes, renderer vs oracle.

The five built-in worlds exercise fixed geometry/material combinations;
these fuzz scenes hit arbitrary mixes (emissive/metal/smooth/rough
materials, overlapping primitives, lights of varying size) and must still
match the independent scalar oracle through the shared RNG streams.
"""

import numpy as np
import pytest

from pathtracer_tpu import RenderConfig, render_image
from pathtracer_tpu.reference.cpu_oracle import render_oracle
from pathtracer_tpu.scene.camera import define_camera
from pathtracer_tpu.scene.schema import WorldBuilder


def _random_world(seed: int) -> WorldBuilder:
    rng = np.random.RandomState(seed)
    b = WorldBuilder()
    # sky (sometimes black, sometimes bright)
    b.add_material(emit=tuple(rng.rand(3) * (rng.rand() < 0.7)))
    # light sphere first (the hardcoded NEE target, win32_main.cpp:683)
    light = b.add_material(albedo=(0, 0, 0), emit=tuple(2 + 20 * rng.rand(3)))
    b.add_sphere(rng.uniform(-3, 3, 3) + (0, 0, 4), 0.5 + rng.rand(), light)

    for _ in range(rng.randint(2, 7)):
        kind = rng.randint(3)
        smooth = rng.rand() < 0.4
        m = b.add_material(
            albedo=tuple(rng.rand(3)),
            metalness=float(rng.rand() * (rng.rand() < 0.5)),
            metal_color=tuple(rng.rand(3)),
            roughness=0.0 if smooth else float(rng.rand()),
            ior=float(1.0 + 0.5 * rng.rand()),
        )
        if kind == 0:
            b.add_sphere(rng.uniform(-3, 3, 3), 0.3 + rng.rand(), m)
        elif kind == 1:
            n = rng.randn(3)
            n /= np.linalg.norm(n)
            b.add_plane(tuple(n), float(rng.uniform(-4, -2)), m)
        else:
            b.add_quad(rng.uniform(-3, 3, 3), rng.uniform(-2, 2, 3),
                       rng.uniform(-2, 2, 3), m)
    return b


@pytest.mark.parametrize("seed", [7, 21, 1001])
def test_random_scene_matches_oracle(seed):
    b = _random_world(seed)
    w, h, pp = 16, 12, 2
    cam = define_camera((0, -8, 1), (0, 0, 0), 35.0, w, h)
    scene = b.finalize()
    cfg = RenderConfig(width=w, height=h, pp=pp, seed=seed)
    img, _, _ = render_image(scene, cam, cfg)
    oracle = render_oracle(b, cam, w, h, pp, seed=seed, world_kind=0)
    img = np.asarray(img)
    d = np.abs(img - oracle).max(axis=-1)
    # same robust gate as the built-in worlds: typical error is float32
    # noise; rare boundary flips allowed
    assert np.median(d) < 1e-4, (seed, float(np.median(d)))
    assert (d > 1e-2).mean() < 0.05, (seed, float((d > 1e-2).mean()))
    assert np.isfinite(img).all()


@pytest.mark.parametrize("seed", [17, 99])
def test_random_scene_with_glass_matches_oracle(seed):
    # dielectric lanes mixed with the full estimator set, RR on: the
    # transmission branch (integrator/oracle twins) must stay in lockstep
    # on the shared uniform streams
    rng = np.random.RandomState(seed)
    b = _random_world(seed)
    glass = b.add_material(albedo=tuple(0.9 + 0.1 * rng.rand(3)),
                           ior=float(1.3 + 0.4 * rng.rand()),
                           transmission=1.0)
    b.add_sphere(rng.uniform(-2, 2, 3), 0.6 + rng.rand() * 0.8, glass)
    w, h, pp = 16, 12, 2
    cam = define_camera((0, -8, 1), (0, 0, 0), 35.0, w, h)
    scene = b.finalize()
    assert scene.any_transmissive
    cfg = RenderConfig(width=w, height=h, pp=pp, seed=seed,
                       use_russian_roulette=True)
    img, _, _ = render_image(scene, cam, cfg)
    oracle = render_oracle(b, cam, w, h, pp, seed=seed, world_kind=0,
                           use_russian_roulette=True)
    img = np.asarray(img)
    d = np.abs(img - oracle).max(axis=-1)
    assert np.median(d) < 1e-4, (seed, float(np.median(d)))
    assert (d > 1e-2).mean() < 0.05, (seed, float((d > 1e-2).mean()))


def test_textured_mesh_scene_driver_equivalence():
    """Interaction coverage: a scene with BOTH the combined texture set
    and a mesh through the wavefront driver vs the unrolled driver."""
    from pathtracer_tpu.scene import textures as T
    from pathtracer_tpu.scene.gltf import load_gltf_triangles
    rng = np.random.RandomState(3)
    b = WorldBuilder()
    b.add_material(emit=(0.3, 0.35, 0.45))
    light = b.add_material(emit=(5.0, 4.5, 4.0))
    b.add_sphere((3, -3, 6), 1.0, light)
    for t in T.load_bespoke_textures():
        b.add_texture(t)
    ground = b.add_material(albedo_idx=1, metalness_idx=2, roughness_idx=3,
                            normal_idx=4)
    b.add_plane((0, 0, 1), 0.0, ground)
    pts, mats = load_gltf_triangles("/root/reference/res/mario.glb", b)
    if pts is None:
        pytest.skip("mario.glb unavailable")
    b.set_mesh(pts * 1.5 + np.float32([0, 0, 1.0]), mats)
    scene = b.finalize()
    assert scene.tex_combined and scene.n_tris > 0
    w, h, pp = 24, 16, 2
    cam = define_camera((0, -6, 2), (0, 0, 1), 35.0, w, h)
    imgs = [np.asarray(render_image(scene, cam, RenderConfig(
        width=w, height=h, pp=pp, seed=1, mode=mode))[0])
        for mode in ("unrolled", "wavefront")]
    d = np.abs(imgs[0] - imgs[1]).max(axis=-1)
    # texel selection turns fma-contraction ulps into rare flips
    assert np.median(d) < 1e-5, float(np.median(d))
    assert (d > 1e-2).mean() < 0.02, float((d > 1e-2).mean())


@pytest.mark.parametrize("seed", [42])
def test_random_scene_with_rr_matches_oracle(seed):
    # Russian roulette consumes slot-4 uniforms identically in renderer and
    # oracle — the golden gate must hold with RR on too.
    b = _random_world(seed)
    w, h, pp = 16, 12, 2
    cam = define_camera((0, -8, 1), (0, 0, 0), 35.0, w, h)
    scene = b.finalize()
    cfg = RenderConfig(width=w, height=h, pp=pp, seed=seed,
                       use_russian_roulette=True)
    img, _, _ = render_image(scene, cam, cfg)
    oracle = render_oracle(b, cam, w, h, pp, seed=seed, world_kind=0,
                           use_russian_roulette=True)
    img = np.asarray(img)
    d = np.abs(img - oracle).max(axis=-1)
    assert np.median(d) < 1e-4, float(np.median(d))
    assert (d > 1e-2).mean() < 0.05, float((d > 1e-2).mean())


@pytest.mark.parametrize("seed", [5, 31])
def test_everything_at_once_matches_oracle(seed):
    """Maximal interaction coverage: fog (HG phase + volume NEE) x
    dispersive glass x plain glass x RR x random geometry, renderer vs
    oracle on the shared streams. Every new estimator branch must stay in
    lockstep with every old one."""
    rng = np.random.RandomState(seed + 7)
    b = _random_world(seed)
    glass = b.add_material(albedo=tuple(0.9 + 0.1 * rng.rand(3)),
                           ior=float(1.3 + 0.4 * rng.rand()),
                           transmission=1.0,
                           dispersion=float(0.05 + 0.1 * rng.rand()))
    b.add_sphere(rng.uniform(-2, 2, 3), 0.6 + rng.rand() * 0.8, glass)
    plain = b.add_material(albedo=(0.95, 0.95, 0.98), ior=1.5,
                           transmission=1.0)
    b.add_sphere(rng.uniform(-2, 2, 3), 0.4 + rng.rand() * 0.5, plain)
    b.set_fog(float(0.02 + 0.04 * rng.rand()),
              albedo=tuple(0.6 + 0.4 * rng.rand(3)),
              g=float(rng.uniform(-0.5, 0.7)))
    # a bump-mapped floor and a UV-textured mesh join the party
    bump_tex = np.repeat(rng.rand(8, 8, 1), 3, 2).astype(np.float32)
    bump_tex = np.round(bump_tex * 255.0) / 255.0
    bti = b.add_texture(bump_tex.astype(np.float32))
    bm = b.add_material(albedo=(0.5, 0.45, 0.4), roughness=0.9,
                        bump_idx=bti, bump_scale=0.3)
    b.add_plane((0, 0, 1), 4.0, bm)
    check = (np.indices((8, 8)).sum(0) % 2)[..., None].repeat(3, 2)
    uv_tex = (check * 0.7 + 0.2).astype(np.float32)
    uv_tex = (np.round(uv_tex * 255.0) / 255.0).astype(np.float32)
    uti = b.add_texture(uv_tex)
    um = b.add_material(albedo=(1.0, 0.9, 0.8), albedo_idx=uti,
                        roughness=0.7)
    base = rng.uniform(-2, 2, 3)
    pts = np.asarray([base + [-1, 0, -1], base + [1, 0, -1],
                      base + [0, 0, 1.2]], np.float32)
    b.set_mesh(pts, np.full(3, um, np.int32),
               uvs=np.asarray([[0, 0], [2, 0], [1, 2]], np.float32))
    w, h, pp = 16, 12, 2
    cam = define_camera((0, -8, 1), (0, 0, 0), 35.0, w, h)
    scene = b.finalize()
    assert scene.any_dispersive and scene.fog_sigma_t > 0
    assert scene.any_bump and scene.has_mesh_uvs
    cfg = RenderConfig(width=w, height=h, pp=pp, seed=seed,
                       use_russian_roulette=True)
    img, _, _ = render_image(scene, cam, cfg)
    oracle = render_oracle(b, cam, w, h, pp, seed=seed, world_kind=0,
                           use_russian_roulette=True)
    img = np.asarray(img)
    d = np.abs(img - oracle).max(axis=-1)
    assert np.median(d) < 1e-4, (seed, float(np.median(d)))
    assert (d > 1e-2).mean() < 0.05, (seed, float((d > 1e-2).mean()))
    assert np.isfinite(img).all()


def test_fog_quad_light_sharded_equivalence():
    """Fog + quad-light NEE (the god-rays configuration) over a 4-device
    mesh vs one device: bit-equal."""
    import jax
    from pathtracer_tpu.parallel.shard import make_mesh, render_image_sharded
    from pathtracer_tpu.scene.worlds import build_world
    from pathtracer_tpu.scene.schema import WORLD_CORNELL_QUAD
    b, cam_d = build_world(WORLD_CORNELL_QUAD)
    b.set_fog(0.0012, albedo=(0.9, 0.9, 0.95), g=0.5)
    scene = b.finalize()
    w, h, pp = 16, 10, 2
    cam = define_camera(cam_d.pos, cam_d.target, cam_d.fov, w, h)
    cfg = RenderConfig(width=w, height=h, pp=pp, seed=2)
    single = np.asarray(render_image(scene, cam, cfg)[0])
    sharded = np.asarray(render_image_sharded(
        scene, cam, cfg, mesh=make_mesh(jax.devices()[:4]))[0])
    np.testing.assert_array_equal(single, sharded)


def test_everything_at_once_driver_equivalence():
    """The maximal-interaction scene (fog x dispersive glass x RR x
    bump floor x UV-textured mesh) through the wavefront driver vs the
    unrolled one — every estimator extension in one compile. Robust gate:
    the two programs contract fma differently."""
    seed = 5
    rng = np.random.RandomState(seed + 7)
    b = _random_world(seed)
    glass = b.add_material(albedo=tuple(0.9 + 0.1 * rng.rand(3)),
                           ior=float(1.3 + 0.4 * rng.rand()),
                           transmission=1.0,
                           dispersion=float(0.05 + 0.1 * rng.rand()))
    b.add_sphere(rng.uniform(-2, 2, 3), 0.6 + rng.rand() * 0.8, glass)
    b.set_fog(0.02, albedo=(0.8, 0.85, 0.9), g=0.4)
    bump_tex = np.repeat(rng.rand(8, 8, 1), 3, 2).astype(np.float32)
    bump_tex = (np.round(bump_tex * 255.0) / 255.0).astype(np.float32)
    bm = b.add_material(albedo=(0.5, 0.45, 0.4), roughness=0.9,
                        bump_idx=b.add_texture(bump_tex), bump_scale=0.3)
    b.add_plane((0, 0, 1), 4.0, bm)
    check = (np.indices((8, 8)).sum(0) % 2)[..., None].repeat(3, 2)
    uv_tex = (np.round((check * 0.7 + 0.2) * 255.0) / 255.0
              ).astype(np.float32)
    um = b.add_material(albedo=(1.0, 0.9, 0.8),
                        albedo_idx=b.add_texture(uv_tex), roughness=0.7)
    pts = np.asarray([[-1, 0, -1], [1, 0, -1], [0, 0, 1.2]], np.float32)
    b.set_mesh(pts, np.full(3, um, np.int32),
               uvs=np.asarray([[0, 0], [2, 0], [1, 2]], np.float32))
    scene = b.finalize()
    assert (scene.any_dispersive and scene.fog_sigma_t > 0
            and scene.any_bump and scene.has_mesh_uvs)
    w, h, pp = 16, 12, 2
    cam = define_camera((0, -8, 1), (0, 0, 0), 35.0, w, h)
    imgs = [np.asarray(render_image(scene, cam, RenderConfig(
        width=w, height=h, pp=pp, seed=seed, use_russian_roulette=True,
        mode=mode))[0]) for mode in ("unrolled", "wavefront")]
    d = np.abs(imgs[0] - imgs[1]).max(axis=-1)
    assert np.median(d) < 1e-5, float(np.median(d))
    assert (d > 5e-2).mean() < 0.02, float((d > 5e-2).mean())
    assert np.isfinite(imgs[1]).all()
