"""Opt-in mip-mapped texture sampling (RenderConfig.mip_scale / --mips).

The reference SHIPS a mip chain builder (GenerateMipmapChain,
win32_main.cpp:2307-2328) but samples mips[0] at every use site
(:620,630,639,1604) — mip selection was on its TODO list. This renderer
finishes the feature behind an opt-in flag: mip-0-only stays the
reference-parity default, and `mip_scale > 0` enables per-bounce LOD
selection with an exact oracle twin (cpu_oracle._mip_lod), so the golden
methodology extends to the new estimator unchanged.

Device layout under test (schema.WorldBuilder.finalize): the combined
2-word texel pyramid concatenates every level's flat plane, LEVEL 0 FIRST —
mip-0-only consumers read the same leading words as before. GenerateMipmapChain's child = parent at uv=(2x,2y) is exact
even-texel decimation, so device level l is literally comb[::2^l, ::2^l]
re-quantization-free.
"""

import numpy as np

import jax
import jax.numpy as jnp

from pathtracer_tpu import RenderConfig, finalize_world, render_image
from pathtracer_tpu.ops import texture as tex
from pathtracer_tpu.reference.cpu_oracle import render_oracle
from pathtracer_tpu.scene.schema import WORLD_DEFAULT
from pathtracer_tpu.scene.worlds import build_world


def _mip_scale(cam, h):
    """The CLI's --mips constant: film-pixel size over lens-film distance
    (texels-per-world-unit folds in via the integrator's k)."""
    return 2.0 * cam.half_film_height / (h * cam.focal_length)


class TestPyramidLayout:
    def test_levels_are_exact_decimation(self):
        """Every pyramid level's flat words == even-texel decimation of the
        level-0 combined words (GenerateMipmapChain semantics, no
        re-quantization)."""
        scene, _ = finalize_world(WORLD_DEFAULT, 8, 8)
        meta = scene.tex_mip_meta
        assert len(meta) >= 2, "world 1's 512x512 set must build a pyramid"
        A = np.asarray(scene.tex_comb_a)
        B = np.asarray(scene.tex_comb_b)
        w0 = meta[0][1]
        lvl0_a = A[: w0 * w0].reshape(w0, w0)
        lvl0_b = B[: w0 * w0].reshape(w0, w0)
        for l, (word_off, w, h) in enumerate(meta):
            assert w == h == w0 >> l
            dec_a = lvl0_a[:: 1 << l, :: 1 << l][:w, :w]
            dec_b = lvl0_b[:: 1 << l, :: 1 << l][:w, :w]
            np.testing.assert_array_equal(
                A[word_off: word_off + w * w].reshape(w, w), dec_a)
            np.testing.assert_array_equal(
                B[word_off: word_off + w * w].reshape(w, w), dec_b)

    def test_level0_leads(self):
        """Mip-0-only consumers are untouched: the leading words are the
        level-0 tables and tex_comb_w/h describe level 0."""
        scene, _ = finalize_world(WORLD_DEFAULT, 8, 8)
        word_off, w, h = scene.tex_mip_meta[0]
        assert word_off == 0
        assert (w, h) == (scene.tex_comb_w, scene.tex_comb_h)


class TestMipSampling:
    def test_lod0_bit_equal_to_mip0(self):
        """bespoke_sample_combined_mip at lod==0 IS the mip-0 fetch."""
        scene, _ = finalize_world(WORLD_DEFAULT, 8, 8)
        rs = np.random.RandomState(3)
        u = jnp.asarray(rs.uniform(-130, 130, (512,)), jnp.float32)
        v = jnp.asarray(rs.uniform(-130, 130, (512,)), jnp.float32)
        a = tex.bespoke_sample_combined(scene, u, v)
        b = tex.bespoke_sample_combined_mip(
            scene, u, v, jnp.zeros((512,), jnp.int32))
        for p, q in zip(jax.tree_util.tree_leaves(a),
                        jax.tree_util.tree_leaves(b)):
            np.testing.assert_array_equal(np.asarray(p), np.asarray(q))


class TestMipGolden:
    def test_world1_mips_vs_oracle(self):
        """World 1 with mips enabled matches the oracle's independent mip
        twin — and genuinely differs from the mip-0 image (the flag does
        something). Same robust gate as the textured goldens."""
        w, h, pp = 24, 16, 2
        scene, cam = finalize_world(WORLD_DEFAULT, w, h)
        ms = _mip_scale(cam, h)
        cfg = RenderConfig(width=w, height=h, pp=pp, seed=0, mip_scale=ms)
        img, _, _ = render_image(scene, cam, cfg)
        b, _ = build_world(WORLD_DEFAULT)
        oracle = render_oracle(b, cam, w, h, pp, seed=0,
                               world_kind=WORLD_DEFAULT, mip_scale=ms)
        img = np.asarray(img)
        d = np.abs(img - oracle).max(axis=-1)
        assert np.median(d) < 1e-4, f"median {np.median(d)}"
        assert (d > 1e-2).mean() < 0.05, f"flips {(d > 1e-2).mean()}"
        o0 = render_oracle(b, cam, w, h, pp, seed=0, world_kind=WORLD_DEFAULT)
        assert float(np.sqrt(((o0 - oracle) ** 2).mean())) > 1e-2, \
            "mips changed nothing — LOD selection is dead"
