"""render_image_sharded over a 4-device mesh == render_image on one device
for the beyond-reference feature scenes (scene/feature_scenes.py):
bit-equal where no texture or dispersive refraction is involved, within
XLA:CPU's shape-dependent fma rounding otherwise (see
test_sharded_worlds.py)."""

import jax
import numpy as np
import pytest

from pathtracer_tpu import RenderConfig, render_image
from pathtracer_tpu.parallel.shard import make_mesh, render_image_sharded
from pathtracer_tpu.scene.camera import define_camera
from pathtracer_tpu.scene.feature_scenes import FEATURE_CASES
from test_sharded_worlds import assert_sharded_equal

EXACT = {"bump": False, "tbn": False, "fog": True, "dispersion": False,
         "everything": True}


@pytest.mark.parametrize("case", sorted(FEATURE_CASES))
def test_feature_sharded_matches_single(case):
    scene, (pos, target, fov), kw = FEATURE_CASES[case]()
    w, h = 12, 8
    cam = define_camera(pos, target, fov, w, h)
    cfg = RenderConfig(width=w, height=h, pp=1, seed=0, **kw)
    single = np.asarray(render_image(scene, cam, cfg)[0])
    sharded = np.asarray(render_image_sharded(
        scene, cam, cfg, mesh=make_mesh(jax.devices()[:4]))[0])
    assert_sharded_equal(single, sharded, EXACT[case])
    assert np.isfinite(single).all()
