"""Multi-device sharding: bit-identical to single-device, collectives work.

Runs on the 8-virtual-device CPU mesh (conftest.py), the strategy SURVEY.md
§4 prescribes for distributed testing without accelerator hardware.
"""

import os
import sys

import jax
import numpy as np
import pytest

from pathtracer_tpu import RenderConfig, finalize_world, render_image
from pathtracer_tpu.parallel.shard import make_mesh, render_image_sharded
from pathtracer_tpu.scene.schema import WORLD_CORNELL_BOX


@pytest.fixture(scope="module")
def cornell_small():
    scene, cam = finalize_world(WORLD_CORNELL_BOX, 24, 16)
    return scene, cam


class TestSharded:
    def test_eight_devices_available(self):
        assert len(jax.devices()) == 8

    def test_sharded_matches_single(self, cornell_small):
        scene, cam = cornell_small
        cfg = RenderConfig(width=24, height=16, pp=2, seed=0)
        img1, packed1, st1 = render_image(scene, cam, cfg)
        img8, packed8, st8 = render_image_sharded(scene, cam, cfg)
        # bit-identical: same pixels, same RNG, any sharding
        np.testing.assert_array_equal(np.asarray(img1), np.asarray(img8))
        np.testing.assert_array_equal(np.asarray(packed1), np.asarray(packed8))

    def test_psum_diagnostics(self, cornell_small):
        scene, cam = cornell_small
        cfg = RenderConfig(width=24, height=16, pp=2, seed=0)
        _, _, st1 = render_image(scene, cam, cfg)
        _, _, st8 = render_image_sharded(scene, cam, cfg)
        # rays_cast psum'd over the mesh; padding adds < n_dev extra paths
        # per sample, each tracing <= MAX_BOUNCE rays
        pad = 8 * 4 * cfg.spp
        assert 0 <= float(st8.rays_cast) - float(st1.rays_cast) <= pad

    def test_uneven_pixel_count(self):
        # 25x17 = 425 pixels, not divisible by 8 -> exercises padding
        scene, cam = finalize_world(WORLD_CORNELL_BOX, 25, 17)
        cfg = RenderConfig(width=25, height=17, pp=1, seed=0)
        img1, _, _ = render_image(scene, cam, cfg)
        img8, _, _ = render_image_sharded(scene, cam, cfg)
        np.testing.assert_array_equal(np.asarray(img1), np.asarray(img8))

    def test_subset_mesh(self, cornell_small):
        scene, cam = cornell_small
        cfg = RenderConfig(width=24, height=16, pp=1, seed=0)
        mesh = make_mesh(jax.devices()[:4])
        img4, _, _ = render_image_sharded(scene, cam, cfg, mesh=mesh)
        img1, _, _ = render_image(scene, cam, cfg)
        np.testing.assert_array_equal(np.asarray(img1), np.asarray(img4))


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestGraftEntry:
    def test_entry_jits(self):
        sys.path.insert(0, REPO)
        import __graft_entry__ as g
        fn, args = g.entry()
        out = jax.jit(fn)(*args)
        assert float(np.asarray(out.rays_cast)) > 0
        assert int(np.asarray(out.samples_done)) == 1

    @pytest.mark.parametrize("n_devices", [8, 4])
    def test_dryrun_multichip(self, n_devices):
        sys.path.insert(0, REPO)
        import __graft_entry__ as g
        g.dryrun_multichip(n_devices)


class TestShardedResume:
    def test_checkpoint_resume_across_renderers(self, cornell_small, tmp_path):
        # checkpoint written by the single-chip renderer resumes sharded,
        # producing the identical final image
        import jax.numpy as jnp
        from pathtracer_tpu.render.progressive import load_checkpoint, save_checkpoint
        scene, cam = cornell_small
        cfg = RenderConfig(width=24, height=16, pp=3, seed=0)
        full, _, _ = render_image(scene, cam, cfg)

        path = str(tmp_path / "ck.npz")
        render_image(scene, cam, cfg, chunk_samples=4,
                     progress_cb=lambda s, t, st:
                         save_checkpoint(path, st) if s == 4 else None)
        loaded, found = load_checkpoint(path, 24 * 16)
        assert found
        resumed, _, st = render_image_sharded(scene, cam, cfg, state=loaded)
        np.testing.assert_array_equal(np.asarray(full), np.asarray(resumed))
        assert int(np.asarray(st.samples_done)) == cfg.spp

    def test_checkpoint_written_by_sharded_render_resumes(
            self, cornell_small, tmp_path):
        # the reverse direction (VERDICT r3 item 8): a checkpoint SAVED
        # mid-render by the SHARDED renderer (padded, device-sharded
        # state) resumes on both renderers to the bit-identical final
        # image
        from pathtracer_tpu.render.progressive import (
            load_checkpoint, save_checkpoint)
        scene, cam = cornell_small
        cfg = RenderConfig(width=24, height=16, pp=3, seed=0)
        full, _, _ = render_image(scene, cam, cfg)

        path = str(tmp_path / "ck_sharded.npz")
        render_image_sharded(
            scene, cam, cfg, chunk_samples=4,
            progress_cb=lambda s, t, st:
                save_checkpoint(path, st) if s == 4 else None)
        loaded, found = load_checkpoint(path, 24 * 16)
        assert found
        assert int(np.asarray(loaded.samples_done)) == 4
        res_sh, _, st_sh = render_image_sharded(scene, cam, cfg,
                                                state=loaded)
        np.testing.assert_array_equal(np.asarray(full), np.asarray(res_sh))
        loaded2, _ = load_checkpoint(path, 24 * 16)
        res_1, _, st_1 = render_image(scene, cam, cfg, state=loaded2)
        np.testing.assert_array_equal(np.asarray(full), np.asarray(res_1))
        assert int(np.asarray(st_sh.samples_done)) == cfg.spp
        assert int(np.asarray(st_1.samples_done)) == cfg.spp
