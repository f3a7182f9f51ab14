"""Volumetric fog (the reference's unrealized '"god rays" and fog, both
via volumetric light transport' TODO, win32_main.cpp:159): HG phase
sampler/pdf properties, unbiased transmittance, and renderer-vs-oracle
goldens through both the XLA driver and the interpret-mode kernel."""

import numpy as np
import pytest

import jax.numpy as jnp

from pathtracer_tpu.ops import sampling
from pathtracer_tpu.scene.camera import define_camera
from pathtracer_tpu.scene.schema import WorldBuilder
from pathtracer_tpu.render.renderer import (
    RenderConfig, init_accum, render_chunk, resolve,
)
from pathtracer_tpu.reference.cpu_oracle import render_oracle
from pathtracer_tpu.utils import prng


class TestHenyeyGreenstein:
    @pytest.mark.parametrize("g", [0.0, 0.3, -0.5, 0.85])
    def test_pdf_integrates_to_one(self, g):
        """Quadrature over the sphere: integral of the HG pdf d(omega) = 1."""
        mu = np.linspace(-1.0, 1.0, 20001)
        pdf = np.asarray(sampling.pdf_henyey_greenstein(jnp.asarray(mu), g))
        trapezoid = getattr(np, "trapezoid", np.trapz)
        total = 2.0 * np.pi * trapezoid(pdf, mu)
        assert abs(total - 1.0) < 1e-3, (g, total)

    @pytest.mark.parametrize("g", [0.0, 0.4, -0.6])
    def test_sample_moments_match(self, g):
        """E[cos theta] of HG samples is exactly g; the sampler's empirical
        mean must agree within Monte-Carlo error."""
        rng = np.random.RandomState(3)
        n = 200_000
        u1 = jnp.asarray(rng.rand(n).astype(np.float32))
        u2 = jnp.asarray(rng.rand(n).astype(np.float32))
        d = sampling.henyey_greenstein_sample(u1, u2, g)
        ct = np.asarray(d.z)
        assert abs(ct.mean() - g) < 4.0 / np.sqrt(n), (g, ct.mean())
        assert (np.abs(np.asarray(d.x) ** 2 + np.asarray(d.y) ** 2
                       + ct ** 2 - 1.0) < 1e-5).all()

    def test_sample_histogram_matches_pdf(self):
        """Binned sample density vs the pdf at g=0.7 (sharp forward lobe)."""
        g = 0.7
        rng = np.random.RandomState(4)
        n = 400_000
        u1 = jnp.asarray(rng.rand(n).astype(np.float32))
        u2 = jnp.asarray(rng.rand(n).astype(np.float32))
        ct = np.asarray(sampling.henyey_greenstein_sample(u1, u2, g).z)
        bins = np.linspace(-1, 1, 41)
        histo, _ = np.histogram(ct, bins=bins, density=True)
        centers = 0.5 * (bins[:-1] + bins[1:])
        # marginal density over cos theta = 2 pi * pdf(omega)
        expect = 2.0 * np.pi * np.asarray(
            sampling.pdf_henyey_greenstein(jnp.asarray(centers), g))
        ok = np.abs(histo - expect) / np.maximum(expect, 1e-3) < 0.1
        assert ok.mean() > 0.9, (histo, expect)


def _fog_world(sigma_t, albedo=(1.0, 1.0, 1.0), g=0.0):
    """Emissive back wall + diffuse floor + a bright NEE sphere light,
    wrapped in fog."""
    b = WorldBuilder()
    b.add_material(emit=(0.05, 0.06, 0.08))          # sky
    light = b.add_material(emit=(8.0, 7.0, 6.0))
    b.add_sphere((4.0, -3.0, 9.0), 1.0, light)       # spheres[0] = NEE light
    wall = b.add_material(emit=(2.0, 1.5, 1.0))
    b.add_quad((-8, 6, -2), (16, 0, 0), (0, 0, 10), wall)  # emissive wall
    floor_m = b.add_material(albedo=(0.55, 0.5, 0.45), roughness=0.9)
    b.add_plane((0, 0, 1), 2.0, floor_m)
    b.set_fog(sigma_t, albedo, g)
    return b


class TestFogRenderer:
    def _render(self, b, w=16, h=8, pp=2, seed=7):
        scene = b.finalize()
        cam = define_camera((0, -14, 1.5), (0, 0, 1.0), 40.0, w, h)
        cfg = RenderConfig(width=w, height=h, pp=pp, seed=seed)
        key = prng.base_key(seed)
        st = render_chunk(scene, cam, cfg, key, np.int32(0), cfg.spp,
                          init_accum(w * h))
        return np.asarray(resolve(st, cfg)), cam

    @pytest.mark.parametrize("g", [0.0, 0.6])
    def test_matches_oracle(self, g):
        """Golden: the fog integrator against its independent scalar
        twin. Lanes whose flight
        distance lands within an ulp of the surface hit can flip between
        scatter/surface across implementations, so gate on median +
        outlier fraction like the streamed-mesh golden."""
        b = _fog_world(0.18, albedo=(0.8, 0.85, 0.9), g=g)
        w, h, pp, seed = 16, 8, 2, 7
        img, cam = self._render(b, w, h, pp, seed)
        oracle = render_oracle(b, cam, w, h, pp, seed=seed, world_kind=0)
        dmax = np.abs(img - oracle).max(axis=-1)
        assert np.median(dmax) < 1e-4, float(np.median(dmax))
        assert (dmax > 1e-2).mean() < 0.05, float((dmax > 1e-2).mean())

    def test_sharded_matches_single(self):
        """The fog block under shard_map on a 4-device mesh renders the
        single-device image bit for bit (every draw is a function of the
        pixel index)."""
        import jax
        from pathtracer_tpu.parallel.shard import (
            make_mesh, render_image_sharded,
        )
        from pathtracer_tpu.render.renderer import render_image
        scene = _fog_world(0.15, albedo=(0.9, 0.9, 0.9), g=0.3).finalize()
        w, h = 16, 8
        cam = define_camera((0, -14, 1.5), (0, 0, 1.0), 40.0, w, h)
        cfg = RenderConfig(width=w, height=h, pp=2, seed=7)
        single = np.asarray(render_image(scene, cam, cfg)[0])
        sharded = np.asarray(render_image_sharded(
            scene, cam, cfg, mesh=make_mesh(jax.devices()[:4]))[0])
        np.testing.assert_array_equal(single, sharded)

    def test_wavefront_bit_equal_to_unrolled(self):
        """Both XLA drivers share the fog block through shade_bounce and
        the counter PRNG, so the regeneration driver is bit-equal to the
        unrolled loop on a fog scene."""
        scene = _fog_world(0.2, albedo=(0.7, 0.8, 0.9), g=-0.2).finalize()
        cam = define_camera((0, -14, 1.5), (0, 0, 1.0), 40.0, 16, 8)
        key = prng.base_key(9)
        imgs = []
        for mode in ("unrolled", "wavefront"):
            cfg = RenderConfig(width=16, height=8, pp=2, seed=9, mode=mode)
            st = render_chunk(scene, cam, cfg, key, np.int32(0), cfg.spp,
                              init_accum(16 * 8))
            imgs.append(np.asarray(resolve(st, cfg)))
        np.testing.assert_array_equal(imgs[0], imgs[1])

    def test_pure_absorption_transmittance(self):
        """With single-scatter albedo 0 the fog is a pure attenuator:
        the mean unclipped radiance of a pixel staring at an emissive
        wall is emit * exp(-sigma_t * t) (distance sampling makes each
        sample emit * 1{flight > t}, a Bernoulli whose mean IS the
        transmittance — the estimator's unbiasedness, checked to MC
        error)."""
        sigma = 0.10
        b = WorldBuilder()
        b.add_material(emit=(0.0, 0.0, 0.0))  # black sky
        lit = b.add_material(emit=(1.0, 1.0, 1.0))
        b.add_sphere((0.0, 500.0, 0.0), 1.0, lit)  # far, irrelevant NEE target
        b.add_quad((-20, 10, -20), (40, 0, 0), (0, 0, 40), lit)
        b.set_fog(sigma, albedo=(0.0, 0.0, 0.0))
        scene = b.finalize()
        w, h, pp = 4, 4, 32  # 1024 samples per pixel
        # fov 2 deg (a HALF-angle under the reference's full-fov tangent
        # quirk): rays are near-paraxial, so every path length ~= 10
        cam = define_camera((0, 0, 0), (0, 10, 0), 2.0, w, h)
        cfg = RenderConfig(width=w, height=h, pp=pp, seed=11)
        key = prng.base_key(11)
        st = render_chunk(scene, cam, cfg, key, np.int32(0), cfg.spp,
                          init_accum(w * h))
        mean = np.asarray(st.sum.x).reshape(-1) / np.asarray(st.count)
        # central pixels stare straight at the wall ~10 units away; rays
        # are slightly oblique so expected t is within a few % of 10
        expect = np.exp(-sigma * 10.0)
        got = float(mean.mean())
        p = expect
        tol = 4.0 * np.sqrt(p * (1 - p) / (w * h * pp * pp)) + 0.02
        assert abs(got - expect) < tol, (got, expect, tol)

    def test_fog_free_scene_unchanged(self):
        """sigma_t = 0 must compile and render the exact reference
        estimator (the fog block is statically absent)."""
        b = _fog_world(0.2)
        b2 = _fog_world(0.2)
        b2.fog = (0.0, (1.0, 1.0, 1.0), 0.0)
        img_fog, _ = self._render(b)
        img_clear, _ = self._render(b2)
        # fog visibly changes the image (sanity that the flag works)
        assert np.abs(img_fog - img_clear).max() > 1e-3
