"""Wavefront driver vs unrolled driver on the other worlds and on the
beyond-reference feature scenes (scene/feature_scenes.py). Both drivers
call the same shade_bounce with the same counter-based draws, so they
agree up to the fma contractions of two different programs."""

import numpy as np
import pytest

from pathtracer_tpu import RenderConfig, finalize_world, render_image
from pathtracer_tpu.scene.schema import WORLD_CORNELL_QUAD, WORLD_MESH_UV


def _render(kind, mode, w, h, pp):
    scene, cam = finalize_world(kind, w, h)
    cfg = RenderConfig(width=w, height=h, pp=pp, seed=0, mode=mode)
    img, _, state = render_image(scene, cam, cfg)
    return np.asarray(img), state


@pytest.mark.parametrize("kind", [WORLD_CORNELL_QUAD, WORLD_MESH_UV])
def test_world_wavefront_matches_unrolled(kind):
    a, sa = _render(kind, "unrolled", w=12, h=8, pp=1)
    b, sb = _render(kind, "wavefront", w=12, h=8, pp=1)
    d = np.abs(a - b).max(axis=-1)
    assert np.median(d) == 0.0, float(np.median(d))
    assert (d > 1e-2).mean() <= 1.0 / d.size, float((d > 1e-2).mean())
    assert float(sa.rays_cast) == float(sb.rays_cast)


@pytest.mark.parametrize("case", ["bump", "tbn", "dispersion", "everything"])
def test_feature_wavefront_matches_unrolled(case):
    from pathtracer_tpu.scene.camera import define_camera
    from pathtracer_tpu.scene.feature_scenes import FEATURE_CASES
    scene, (pos, target, fov), kw = FEATURE_CASES[case]()
    w, h = 12, 8
    cam = define_camera(pos, target, fov, w, h)
    imgs = [np.asarray(render_image(scene, cam, RenderConfig(
        width=w, height=h, pp=2, seed=1, mode=mode, **kw))[0])
        for mode in ("unrolled", "wavefront")]
    d = np.abs(imgs[0] - imgs[1]).max(axis=-1)
    assert np.median(d) < 1e-6, float(np.median(d))
    assert (d > 1e-2).mean() <= 2.0 / d.size, float((d > 1e-2).mean())
