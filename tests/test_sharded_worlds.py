"""render_image_sharded over a 4-device mesh == render_image on one
device for every world that ships with the checkout: every random number
and every per-lane operation is a function of the pixel index, so how
pixels are split across devices cannot change a decision. Untextured
worlds are bit-equal. On XLA:CPU the textured ones can differ in the last
bits, because the CPU backend contracts fma differently for different
array lengths (max 2.4e-6 measured); on the GPU they were bit-equal at
1280x720 (chip_smoke.py --four)."""

import jax
import numpy as np
import pytest

from pathtracer_tpu import RenderConfig, finalize_world, render_image
from pathtracer_tpu.parallel.shard import make_mesh, render_image_sharded
from pathtracer_tpu.scene.schema import (
    WORLD_CORNELL_BOX, WORLD_CORNELL_QUAD, WORLD_DEFAULT,
    WORLD_MESH_UV, WORLD_RAYTRACING_ONE_WEEKEND,
)


def assert_sharded_equal(single, sharded, exact):
    a, b = np.asarray(single), np.asarray(sharded)
    if exact:
        np.testing.assert_array_equal(a, b)
        return
    d = np.abs(a - b)
    assert (d == 0).mean() > 0.8, float((d == 0).mean())
    assert d.max() < 1e-4, float(d.max())


@pytest.mark.parametrize("kind,exact", [
    (WORLD_DEFAULT, False), (WORLD_CORNELL_BOX, True),
    (WORLD_RAYTRACING_ONE_WEEKEND, True), (WORLD_CORNELL_QUAD, True),
    (WORLD_MESH_UV, False),
])
def test_world_sharded_matches_single(kind, exact):
    w, h = 12, 8
    scene, cam = finalize_world(kind, w, h)
    cfg = RenderConfig(width=w, height=h, pp=1, seed=0)
    single, packed1, st1 = render_image(scene, cam, cfg)
    sharded, packed4, st4 = render_image_sharded(
        scene, cam, cfg, mesh=make_mesh(jax.devices()[:4]))
    assert_sharded_equal(single, sharded, exact)
    assert_sharded_equal(packed1, packed4, exact)
    # 96 pixels split evenly over 4 devices: no padding lanes
    assert float(st1.rays_cast) == float(st4.rays_cast) > 0
