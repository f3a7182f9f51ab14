"""Counter-based PRNG discipline for the path tracer.

The reference uses a single global Mersenne-Twister shared (unsynchronized)
across all render threads (reference include/ray_math.hpp:245-248) — a data
race it documents itself. This renderer replaces it with a *pure
counter-based scheme*: every random number is a deterministic function of

    (seed, pixel_index, sample_index, stream_tag, bounce, slot)

Consequences:

- no shared state, so the renderer is trivially SPMD over any device mesh;
- values are independent of batch shape / tiling / sharding, so a multi-chip
  render is bit-identical to single-chip;
- the CPU scalar oracle (pathtracer_tpu/reference) consumes the *same*
  stream from an INDEPENDENT pure-numpy reimplementation (same constants,
  written separately; bit-equality asserted in tests/test_math.py), which
  is what lets golden tests gate at RMSE ~ float32 noise instead of
  Monte-Carlo noise while still covering this module itself.

Generator: PCG4D (Jarzynski & Olano, "Hash Functions for GPU Rendering",
JCGT 2020) — the standard counter hash for production GPU path tracers.
One evaluation mixes a (seed, pixel, sample, tag) lane vector into 4
uniform u32s in ~20 integer ops; an earlier threefry implementation of
this module measured at 59% of total frame time, PCG4D is ~10x cheaper
with rendering-grade statistical quality (tested in tests/test_math.py).

Slot layout per bounce (BOUNCE_SLOTS uniforms in [0,1)):
    0: estimator coin    (bSpecular = u > 0.5, win32_main.cpp:661)
    1: pdf-mixture coin  (bSampleCosine = u > 0.5, win32_main.cpp:678)
    2: direction u1      (phi for cosine/GGX/to-sphere samplers)
    3: direction u2      (radius/theta/z for the samplers)
    4: russian roulette  (reference lists RR as TODO win32_main.cpp:187;
                          north-star requires it — see integrator)
    5: fog flight distance (volume events, integrator fog block; volume
                          and surface events are disjoint per lane, so
                          surface estimators reuse 0-3 at volume events)
    6: dispersion channel (spectral coin for dispersive dielectrics —
                          must be fresh: u[5] conditioned on "reached the
                          surface" is no longer uniform under fog)
    7: spare
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

# Stream tags. Bounce streams use TAG_BOUNCE + bounce*2 + block. Arbitrary
# but fixed forever (changing them invalidates nothing but reproducibility
# of old renders).
TAG_JITTER = 0x0100_0000
TAG_LENS = 0x0200_0000
TAG_BOUNCE = 0x0400_0000

BOUNCE_SLOTS = 8

# python scalars, so they fold into the compiled code as immediates
_U24 = 0xFFFFFF
_INV_U24 = 1.0 / (1 << 24)


class PathStream(NamedTuple):
    """Per-path RNG identity: (seed, pixel, sample) as uint32 arrays.
    A pytree — flows through jit/shard_map/scan for free."""
    seed: jnp.ndarray
    pixel: jnp.ndarray
    sample: jnp.ndarray


def _pcg4d(a, b, c, d):
    """PCG4D mix: 4 x uint32 in -> 4 x uint32 out (JCGT 2020, listing 6)."""
    u = jnp.uint32
    mul, inc = u(1664525), u(1013904223)
    a = a * mul + inc
    b = b * mul + inc
    c = c * mul + inc
    d = d * mul + inc
    a = a + b * d
    b = b + c * a
    c = c + a * b
    d = d + b * c
    a = a ^ (a >> u(16))
    b = b ^ (b >> u(16))
    c = c ^ (c >> u(16))
    d = d ^ (d >> u(16))
    a = a + b * d
    b = b + c * a
    c = c + a * b
    d = d + b * c
    return a, b, c, d


def _to_unit(x: jnp.ndarray) -> jnp.ndarray:
    """uint32 -> float32 uniform in [0, 1) via the top 24 bits.

    The masked value fits in 24 bits, so it is bitcast to int32 before
    the float conversion. Any exact conversion gives the same value; this
    one is kept because the oracle twin (reference/cpu_oracle.py) is
    written against these exact bits.
    """
    masked = (x >> jnp.uint32(8)) & _U24
    return jax.lax.bitcast_convert_type(masked, jnp.int32).astype(jnp.float32) * _INV_U24


def _draw4(stream: PathStream, tag) -> tuple:
    a, b, c, d = _pcg4d(
        stream.seed,
        stream.pixel,
        stream.sample,
        jnp.uint32(0) + jnp.asarray(tag).astype(jnp.uint32),
    )
    return _to_unit(a), _to_unit(b), _to_unit(c), _to_unit(d)


# --- public API --------------------------------------------------------------

def base_key(seed: int) -> jnp.ndarray:
    """The render-wide seed (kept name for API continuity)."""
    return jnp.uint32(seed)


def path_key(key, pixel_idx, sample_idx) -> PathStream:
    """Identity of one path (scalar variant, used by the oracle)."""
    return PathStream(
        jnp.uint32(key),
        jnp.asarray(pixel_idx).astype(jnp.uint32),
        jnp.asarray(sample_idx).astype(jnp.uint32),
    )


def path_keys(key, pixel_idx: jnp.ndarray, sample_idx) -> PathStream:
    """Vectorized path identities for arrays of pixel/sample indices."""
    pixel = jnp.asarray(pixel_idx).astype(jnp.uint32).ravel()
    sample = jnp.broadcast_to(
        jnp.asarray(sample_idx).astype(jnp.uint32), pixel.shape)
    return PathStream(jnp.broadcast_to(jnp.uint32(key), pixel.shape), pixel, sample)


def jitter_uniforms(stream: PathStream):
    """Two uniforms for stratified sub-pixel jitter (win32_main.cpp:1056-1057).

    Returns a TUPLE of (N,) arrays, never a stacked (N, 2) array, in the
    structure-of-arrays layout every per-lane quantity uses (utils/vec.py)."""
    a, b, _, _ = _draw4(stream, TAG_JITTER)
    return a, b


def lens_uniforms(stream: PathStream):
    """Two uniforms for the thin-lens sensor offset (win32_main.cpp:1116-1119)."""
    a, b, _, _ = _draw4(stream, TAG_LENS)
    return a, b


def bounce_uniforms(stream: PathStream, bounce):
    """BOUNCE_SLOTS uniforms for one bounce (two PCG4D blocks), as a tuple
    of (N,) arrays (see jitter_uniforms for why not stacked). Slots 0-5
    are the historical six; 6-7 expose the second block's remaining words
    (values of the first six are unchanged)."""
    base = TAG_BOUNCE + jnp.asarray(bounce).astype(jnp.uint32) * jnp.uint32(2)
    a0, a1, a2, a3 = _draw4(stream, base)
    b0, b1, b2, b3 = _draw4(stream, base + jnp.uint32(1))
    return a0, a1, a2, a3, b0, b1, b2, b3


def normal_from_uniforms(u1, u2, stddev=1.0):
    """Gaussian-distributed sample from two counter uniforms — the
    RandomNormal role (ray_math.hpp:278-296; unused by the reference's
    render path). The reference draws from a static mt19937 behind
    std::normal_distribution; the counter-based scheme instead maps two
    uniforms through Box-Muller, keeping the no-shared-state discipline.
    u1 is clamped away from 0 (log(0) = -inf)."""
    u1 = jnp.maximum(u1, jnp.float32(1.0 / (1 << 24)))
    r = jnp.sqrt(-2.0 * jnp.log(u1))
    return stddev * r * jnp.cos(jnp.float32(2.0 * math.pi) * u2)


# Vectorized aliases (same functions — PathStream broadcasts naturally).
jitter_uniforms_v = jitter_uniforms
lens_uniforms_v = lens_uniforms
bounce_uniforms_v = bounce_uniforms
