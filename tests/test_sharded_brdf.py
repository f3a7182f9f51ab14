"""World 2 (the 121-sphere BRDF grid) over a 4-device mesh == one device,
bit for bit. Its own file: the unrolled 121-sphere intersection makes it
the slowest world to compile on XLA:CPU."""

import jax
import numpy as np

from pathtracer_tpu import RenderConfig, finalize_world, render_image
from pathtracer_tpu.parallel.shard import make_mesh, render_image_sharded
from pathtracer_tpu.scene.schema import WORLD_BRDF_TEST


def test_brdf_world_sharded_matches_single():
    w, h = 12, 8
    scene, cam = finalize_world(WORLD_BRDF_TEST, w, h)
    cfg = RenderConfig(width=w, height=h, pp=1, seed=0)
    single, _, st1 = render_image(scene, cam, cfg)
    sharded, _, st4 = render_image_sharded(
        scene, cam, cfg, mesh=make_mesh(jax.devices()[:4]))
    np.testing.assert_array_equal(np.asarray(single), np.asarray(sharded))
    assert float(st1.rays_cast) == float(st4.rays_cast) > 0
