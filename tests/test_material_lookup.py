"""Material lookup (render/integrator._material_lookup): the unrolled
compare/select sweep and the per-lane gather are two forms of one pure
lookup and must return identical values at every table size, on both
sides of the size threshold that picks between them."""

import numpy as np
import pytest

import jax.numpy as jnp

from pathtracer_tpu.render import integrator as integ
from pathtracer_tpu.scene.schema import WorldBuilder
from pathtracer_tpu.utils.vec import Vec3


def _scene(n_mats, seed=4):
    rng = np.random.RandomState(seed)
    b = WorldBuilder()
    for _ in range(n_mats):
        b.add_material(albedo=tuple(rng.rand(3)), emit=tuple(rng.rand(3)),
                       metal_color=tuple(rng.rand(3)),
                       metalness=float(rng.rand()),
                       roughness=float(rng.rand()),
                       ior=float(1 + rng.rand()),
                       transmission=float(rng.rand() < 0.2),
                       albedo_idx=int(rng.randint(0, 5)),
                       bump_idx=int(rng.randint(0, 2)))
    b.add_sphere((0, 0, 0), 1.0, 0)
    return b.finalize()


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        for x, y in zip(a[k] if isinstance(a[k], Vec3) else (a[k],),
                        b[k] if isinstance(b[k], Vec3) else (b[k],)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=k)


@pytest.mark.parametrize(
    "n_mats", [1, 2, 17, 128, 129, 191, 192, 193, 424, 1100])
def test_sweep_equals_gather(n_mats):
    scene = _scene(n_mats)
    rng = np.random.RandomState(5)
    mat = jnp.asarray(rng.randint(0, n_mats, (512,)), jnp.int32)
    _assert_same(integ._material_lookup(scene, mat, sweep=True),
                 integ._material_lookup(scene, mat, sweep=False))


def _primitives(scene, mat, **kw):
    import jax
    jaxpr = jax.make_jaxpr(
        lambda m: integ._material_lookup(scene, m, **kw))(mat)
    return [e.primitive.name for e in jaxpr.jaxpr.eqns]


def test_default_form_follows_the_threshold():
    """sweep=None: the select sweep up to _SELECT_LOOKUP_MAX rows (no
    gather in the program, one select chain per row), per-lane gathers
    above it (a short program)."""
    limit = integ._SELECT_LOOKUP_MAX
    mat = jnp.arange(8, dtype=jnp.int32) % 2
    above = _primitives(_scene(limit + 1), mat)
    assert "gather" in above
    if limit >= 2:
        at = _primitives(_scene(limit), mat)
        assert "gather" not in at and len(at) >= limit
    forced = _primitives(_scene(limit + 1), mat, sweep=True)
    assert "gather" not in forced and len(forced) > limit
    assert len(forced) > 4 * len(above)
