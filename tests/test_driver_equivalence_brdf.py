"""World 2 (the 121-sphere BRDF grid) through the wavefront driver vs the
unrolled driver. Its own file: four unrolled copies of the 121-sphere
intersection make it the slowest program to compile on XLA:CPU."""

import numpy as np

from pathtracer_tpu import RenderConfig, finalize_world, render_image
from pathtracer_tpu.scene.schema import WORLD_BRDF_TEST


def test_brdf_world_wavefront_matches_unrolled():
    w, h = 12, 8
    scene, cam = finalize_world(WORLD_BRDF_TEST, w, h)
    out = [render_image(scene, cam, RenderConfig(
        width=w, height=h, pp=1, seed=0, mode=mode))
        for mode in ("unrolled", "wavefront")]
    a, b = (np.asarray(o[0]) for o in out)
    d = np.abs(a - b).max(axis=-1)
    assert np.median(d) == 0.0, float(np.median(d))
    assert (d > 1e-2).mean() <= 1.0 / d.size, float((d > 1e-2).mean())
    assert float(out[0][2].rays_cast) == float(out[1][2].rays_cast)
