"""Path-regeneration wavefront driver == unrolled driver, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer_tpu import RenderConfig, finalize_world, render_image
from pathtracer_tpu.render.integrator import (
    BOUNCE_COUNT, PRIMARY_RAY_NORMALS, REGULAR, TERMINATION_CONDITION,
    VARIANCE,
)
from pathtracer_tpu.render.renderer import init_accum, render_chunk
from pathtracer_tpu.scene.schema import (
    WORLD_CORNELL_BOX, WORLD_CORNELL_QUAD, WORLD_DEFAULT,
    WORLD_RAYTRACING_ONE_WEEKEND,
)
from pathtracer_tpu.utils import prng


def _render(kind, mode, w=20, h=12, pp=3, rr=False):
    scene, cam = finalize_world(kind, w, h)
    cfg = RenderConfig(width=w, height=h, pp=pp, seed=0, mode=mode,
                       use_russian_roulette=rr)
    img, _, state = render_image(scene, cam, cfg)
    return np.asarray(img), state


class TestWavefrontEquivalence:
    def test_cornell_identical(self):
        a, sa = _render(WORLD_CORNELL_BOX, "unrolled")
        b, sb = _render(WORLD_CORNELL_BOX, "wavefront")
        np.testing.assert_array_equal(a, b)
        # identical work too: every path traces the same segments
        assert float(sa.rays_cast) == float(sb.rays_cast)

    def test_textured_world_matches(self):
        # The two drivers are different XLA programs, so FMA/fusion choices
        # differ by ulps; texel selection amplifies a few lanes (same effect
        # as the golden-gate boundary flips). Median must be ~exact.
        a, _ = _render(WORLD_DEFAULT, "unrolled", w=12, h=8, pp=2)
        b, _ = _render(WORLD_DEFAULT, "wavefront", w=12, h=8, pp=2)
        d = np.abs(a - b).max(axis=-1)
        assert np.median(d) == 0.0
        assert d.max() < 1e-3

    def test_thin_lens_matches(self):
        a, _ = _render(WORLD_RAYTRACING_ONE_WEEKEND, "unrolled", w=10, h=8, pp=2)
        b, _ = _render(WORLD_RAYTRACING_ONE_WEEKEND, "wavefront", w=10, h=8, pp=2)
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4)

    def test_auto_picks_wavefront_for_regular(self):
        assert RenderConfig(mode="auto").resolved_mode() == "wavefront"
        assert RenderConfig(mode="auto", debug_kind="bounce_count").resolved_mode() == "unrolled"


class TestRussianRoulette:
    def test_rr_identical_across_drivers(self):
        a, _ = _render(WORLD_CORNELL_BOX, "unrolled", rr=True)
        b, _ = _render(WORLD_CORNELL_BOX, "wavefront", rr=True)
        np.testing.assert_array_equal(a, b)

    def test_rr_reduces_work_and_stays_unbiased(self):
        scene, cam = finalize_world(WORLD_CORNELL_BOX, 16, 12)
        base = RenderConfig(16, 12, pp=6, seed=0)
        rr = RenderConfig(16, 12, pp=6, seed=0, use_russian_roulette=True)
        img0, _, st0 = render_image(scene, cam, base)
        img1, _, st1 = render_image(scene, cam, rr)
        assert float(st1.rays_cast) < float(st0.rays_cast)
        a, b = np.asarray(img0), np.asarray(img1)
        # unbiased: means agree within Monte-Carlo noise
        assert abs(a.mean() - b.mean()) < 0.05 * max(a.mean(), 1e-6)


class TestDispatch:
    """Regular and variance renders run the path-regeneration driver;
    debug kinds always run the unrolled bounce loop."""

    @pytest.mark.parametrize("kind,driver", [
        (REGULAR, "wavefront"), (VARIANCE, "wavefront"),
        (BOUNCE_COUNT, "unrolled"), (PRIMARY_RAY_NORMALS, "unrolled"),
        (TERMINATION_CONDITION, "unrolled"),
    ])
    def test_driver_for_kind(self, kind, driver, monkeypatch):
        from pathtracer_tpu.render import renderer, wavefront
        calls = []
        real = wavefront.render_chunk_wavefront
        monkeypatch.setattr(wavefront, "render_chunk_wavefront",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
        assert RenderConfig(debug_kind=kind).resolved_mode() == driver
        scene, cam = finalize_world(WORLD_CORNELL_BOX, 4, 2)
        cfg = RenderConfig(4, 2, pp=1, debug_kind=kind)
        st = renderer.render_samples(
            scene, cam, cfg, prng.base_key(0), jnp.int32(0), 1,
            init_accum(8), jnp.arange(8, dtype=jnp.int32))
        assert bool(calls) == (driver == "wavefront")
        assert int(st.samples_done) == 1

    def test_unrolled_mode_only_for_regular_kinds(self):
        assert RenderConfig(mode="unrolled").resolved_mode() == "unrolled"
        assert RenderConfig(mode="wavefront",
                            debug_kind=BOUNCE_COUNT).resolved_mode() == "unrolled"


def _chunk(kind, w, h, pp, n_samples, mode, s0=0, state=None):
    scene, cam = finalize_world(kind, w, h)
    cfg = RenderConfig(w, h, pp=pp, seed=0, mode=mode)
    state = init_accum(w * h) if state is None else state
    return render_chunk(scene, cam, cfg, prng.base_key(0), jnp.int32(s0),
                        n_samples, state)


class TestDriverEquality:
    """The wavefront driver against the unrolled driver on single chunks:
    same samples, same accumulation order per pixel."""

    def test_cornell_bit_exact(self):
        ref = _chunk(WORLD_CORNELL_BOX, 16, 8, 1, 2, "unrolled")
        wav = _chunk(WORLD_CORNELL_BOX, 16, 8, 1, 2, "wavefront")
        for a, b in ((ref.sum.x, wav.sum.x), (ref.sum.z, wav.sum.z),
                     (ref.count, wav.count)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert float(ref.rays_cast) == float(wav.rays_cast)
        assert int(wav.samples_done) == 2

    def test_cornell_quad_light(self):
        ref = _chunk(WORLD_CORNELL_QUAD, 16, 8, 1, 2, "unrolled")
        wav = _chunk(WORLD_CORNELL_QUAD, 16, 8, 1, 2, "wavefront")
        a, b = np.asarray(ref.sum.x), np.asarray(wav.sum.x)
        assert (np.abs(a - b) > 1e-2).mean() <= 2e-3
        np.testing.assert_array_equal(np.asarray(ref.count),
                                      np.asarray(wav.count))

    def test_odd_size(self):
        # 23x15 = 345 pixels: no size is special to either driver
        ref = _chunk(WORLD_CORNELL_BOX, 23, 15, 1, 1, "unrolled")
        wav = _chunk(WORLD_CORNELL_BOX, 23, 15, 1, 1, "wavefront")
        np.testing.assert_array_equal(np.asarray(ref.sum.y),
                                      np.asarray(wav.sum.y))
        assert float(ref.rays_cast) == float(wav.rays_cast)

    def test_multi_chunk(self):
        # two chunks of 2 samples resume at s0 = 2 on both drivers
        ref = _chunk(WORLD_CORNELL_BOX, 12, 8, 2, 2, "unrolled")
        ref = _chunk(WORLD_CORNELL_BOX, 12, 8, 2, 2, "unrolled", 2, ref)
        wav = _chunk(WORLD_CORNELL_BOX, 12, 8, 2, 2, "wavefront")
        wav = _chunk(WORLD_CORNELL_BOX, 12, 8, 2, 2, "wavefront", 2, wav)
        np.testing.assert_array_equal(np.asarray(ref.sum.x),
                                      np.asarray(wav.sum.x))
        assert int(wav.samples_done) == 4

    def test_world1_textured(self):
        ref = _chunk(WORLD_DEFAULT, 16, 8, 2, 2, "unrolled")
        wav = _chunk(WORLD_DEFAULT, 16, 8, 2, 2, "wavefront")
        a, b = np.asarray(ref.sum.x), np.asarray(wav.sum.x)
        assert np.median(np.abs(a - b)) == 0.0
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-3)
        np.testing.assert_array_equal(np.asarray(ref.count),
                                      np.asarray(wav.count))
