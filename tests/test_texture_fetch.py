"""Flat-gather texture fetches (ops/texture.py) against the oracle's
scalar samplers (reference/cpu_oracle.sample_texture_host and
bespoke_sample_host): the combined 4-map set, a per-layer stack of mixed
sizes, and the combined mip pyramid."""

import numpy as np
import pytest

import jax.numpy as jnp

from pathtracer_tpu import finalize_world
from pathtracer_tpu.ops import texture as tex
from pathtracer_tpu.reference.cpu_oracle import (
    bespoke_sample_host, sample_texture_host,
)
from pathtracer_tpu.scene.schema import WORLD_DEFAULT, WorldBuilder
from pathtracer_tpu.scene.textures import generate_mipmap_chain
from pathtracer_tpu.scene.worlds import build_world

ATOL = 1e-6  # f32 blend of 8-bit-grid texels; same op order on both sides


def _uv(n, lo, hi, seed):
    rs = np.random.RandomState(seed)
    return (rs.uniform(lo, hi, n).astype(np.float32),
            rs.uniform(lo, hi, n).astype(np.float32))


def test_combined_fetch_matches_oracle_sampler():
    scene, _ = finalize_world(WORLD_DEFAULT, 8, 8)
    b, _ = build_world(WORLD_DEFAULT)
    alb, met, rgh, nrm = b.textures
    u, v = _uv(64, -3.0, 3.0, 1)
    a_c, m_c, r_c, n_c = tex.bespoke_sample_combined(
        scene, jnp.asarray(u), jnp.asarray(v))
    for i in range(len(u)):
        want = bespoke_sample_host(alb, u[i], v[i])
        got = [float(a_c.x[i]), float(a_c.y[i]), float(a_c.z[i])]
        np.testing.assert_allclose(got, want, atol=ATOL)
        np.testing.assert_allclose(
            float(m_c[i]), bespoke_sample_host(met, u[i], v[i])[0], atol=ATOL)
        np.testing.assert_allclose(
            float(r_c[i]), bespoke_sample_host(rgh, u[i], v[i])[0], atol=ATOL)
        np.testing.assert_allclose(
            [float(n_c.x[i]), float(n_c.y[i]), float(n_c.z[i])],
            bespoke_sample_host(nrm, u[i], v[i]), atol=ATOL)


@pytest.mark.parametrize("bespoke", [False, True])
def test_stack_fetch_matches_oracle_sampler(bespoke):
    rng = np.random.RandomState(2)
    b = WorldBuilder()
    texs = [(np.round(rng.rand(*shape, 3) * 255) / 255).astype(np.float32)
            for shape in ((8, 16), (32, 32), (6, 10))]
    for t in texs:
        b.add_texture(t)
    b.add_material()
    scene = b.finalize()
    n = 96
    layer = np.arange(n) % len(texs)
    u, v = _uv(n, -40.0, 40.0, 3)
    fetch = tex.bespoke_sample if bespoke else tex.sample_texture
    host = bespoke_sample_host if bespoke else sample_texture_host
    got = fetch(scene, jnp.asarray(layer), jnp.asarray(u), jnp.asarray(v))
    for i in range(n):
        np.testing.assert_allclose(
            [float(got.x[i]), float(got.y[i]), float(got.z[i])],
            host(texs[layer[i]], u[i], v[i]), atol=ATOL)


def test_mip_fetch_matches_oracle_sampler():
    scene, _ = finalize_world(WORLD_DEFAULT, 8, 8)
    b, _ = build_world(WORLD_DEFAULT)
    chain = generate_mipmap_chain(b.textures[0])
    n_lvl = len(scene.tex_mip_meta)
    assert n_lvl == len(chain)
    n = 64
    lod = np.arange(n) % n_lvl
    u, v = _uv(n, -3.0, 3.0, 4)
    a_c, _, _, _ = tex.bespoke_sample_combined_mip(
        scene, jnp.asarray(u), jnp.asarray(v), jnp.asarray(lod, jnp.int32))
    for i in range(n):
        np.testing.assert_allclose(
            [float(a_c.x[i]), float(a_c.y[i]), float(a_c.z[i])],
            bespoke_sample_host(chain[lod[i]], u[i], v[i]), atol=ATOL)
