"""Structure-of-arrays 3-vector math.

The reference implements an AoS ``v3`` struct with operator overloads
(reference: include/ray_math.hpp:53-241). Here the layout is
structure-of-arrays: each component is its own array, so a batch of N
vectors is three contiguous length-N arrays (coalesced loads on the GPU,
no size-3 minor axis). ``Vec3`` is a NamedTuple (hence automatically a JAX pytree) of three
same-shaped arrays; every op below is elementwise over the batch and fuses
under XLA.

All semantics (cross product component order, normalize = divide by
magnitude, hadamard, lerp, clamp) mirror include/ray_math.hpp:204-317 exactly
so the integrator can be validated bit-for-bit against a scalar oracle.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import jax.numpy as jnp

Scalar = Union[float, jnp.ndarray]


class Vec3(NamedTuple):
    """A batch of 3-vectors stored as three component arrays (SoA)."""

    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    # --- arithmetic -------------------------------------------------------
    def __add__(self, other: "Vec3") -> "Vec3":  # type: ignore[override]
        return Vec3(self.x + other.x, self.y + other.y, self.z + other.z)

    def __sub__(self, other: "Vec3") -> "Vec3":
        return Vec3(self.x - other.x, self.y - other.y, self.z - other.z)

    def __neg__(self) -> "Vec3":
        return Vec3(-self.x, -self.y, -self.z)

    def __mul__(self, s: Scalar) -> "Vec3":
        """Scalar (or broadcastable array) multiply; use :func:`hadamard`
        for elementwise vector*vector (ray_math.hpp:233)."""
        return Vec3(self.x * s, self.y * s, self.z * s)

    __rmul__ = __mul__

    @property
    def shape(self):
        return jnp.shape(self.x)

    @property
    def dtype(self):
        return jnp.asarray(self.x).dtype

    def astype(self, dtype) -> "Vec3":
        return Vec3(self.x.astype(dtype), self.y.astype(dtype), self.z.astype(dtype))


def vec3(x: Scalar, y: Scalar, z: Scalar, dtype=jnp.float32) -> Vec3:
    """Construct a Vec3 from python scalars / arrays (ray_math.hpp:181 V3)."""
    return Vec3(jnp.asarray(x, dtype), jnp.asarray(y, dtype), jnp.asarray(z, dtype))


def splat(v, batch_shape=(), dtype=jnp.float32) -> Vec3:
    """Broadcast a length-3 constant to a batch of Vec3."""
    x, y, z = v
    return Vec3(
        jnp.full(batch_shape, x, dtype),
        jnp.full(batch_shape, y, dtype),
        jnp.full(batch_shape, z, dtype),
    )


def from_stacked(a: jnp.ndarray) -> Vec3:
    """Convert a (..., 3) stacked array into SoA Vec3."""
    return Vec3(a[..., 0], a[..., 1], a[..., 2])


def to_stacked(v: Vec3) -> jnp.ndarray:
    """Convert SoA Vec3 to a (..., 3) stacked array (host I/O boundary)."""
    return jnp.stack([v.x, v.y, v.z], axis=-1)


def dot(a: Vec3, b: Vec3) -> jnp.ndarray:
    """ray_math.hpp:228 Dot."""
    return a.x * b.x + a.y * b.y + a.z * b.z


def hadamard(a: Vec3, b: Vec3) -> Vec3:
    """Elementwise product (ray_math.hpp:233 Hadamard)."""
    return Vec3(a.x * b.x, a.y * b.y, a.z * b.z)


def hadamard_div(a: Vec3, b: Vec3) -> Vec3:
    """Elementwise divide (ray_math.hpp:238 HadamardDiv)."""
    return Vec3(a.x / b.x, a.y / b.y, a.z / b.z)


def cross(a: Vec3, b: Vec3) -> Vec3:
    """ray_math.hpp:220 Cross."""
    return Vec3(
        a.y * b.z - b.y * a.z,
        a.z * b.x - b.z * a.x,
        a.x * b.y - b.x * a.y,
    )


def magnitude_squared(a: Vec3) -> jnp.ndarray:
    """ray_math.hpp:347 MagnitudeSquared."""
    return a.x * a.x + a.y * a.y + a.z * a.z


def magnitude(a: Vec3) -> jnp.ndarray:
    """ray_math.hpp:204 Magnitude."""
    return jnp.sqrt(magnitude_squared(a))


def normalize(a: Vec3, eps: float = 0.0) -> Vec3:
    """ray_math.hpp:211 Normalize. The reference asserts magnitude > 0; here
    a zero-length input yields inf/nan lanes which downstream masks must
    kill (we never resample like win32_main.cpp:1068 — see integrator)."""
    m = magnitude(a)
    if eps:
        m = jnp.maximum(m, eps)
    inv = 1.0 / m
    return Vec3(a.x * inv, a.y * inv, a.z * inv)


def normalize_safe(a: Vec3, fallback=(0.0, 0.0, 1.0)) -> Vec3:
    """Normalize, returning ``fallback`` for zero-length lanes instead of nan."""
    m2 = magnitude_squared(a)
    ok = m2 > 0.0
    inv = jnp.where(ok, 1.0 / jnp.sqrt(jnp.where(ok, m2, 1.0)), 0.0)
    return Vec3(
        jnp.where(ok, a.x * inv, fallback[0]),
        jnp.where(ok, a.y * inv, fallback[1]),
        jnp.where(ok, a.z * inv, fallback[2]),
    )


def lerp(a: Vec3, b: Vec3, p: Scalar) -> Vec3:
    """(1-p)*a + p*b (ray_math.hpp:306 Lerp)."""
    return Vec3(
        (1.0 - p) * a.x + p * b.x,
        (1.0 - p) * a.y + p * b.y,
        (1.0 - p) * a.z + p * b.z,
    )


def clamp(v: Vec3, lo: Vec3, hi: Vec3) -> Vec3:
    """ray_math.hpp:298 Clamp (per-component min/max)."""
    return Vec3(
        jnp.maximum(lo.x, jnp.minimum(v.x, hi.x)),
        jnp.maximum(lo.y, jnp.minimum(v.y, hi.y)),
        jnp.maximum(lo.z, jnp.minimum(v.z, hi.z)),
    )


def where(mask: jnp.ndarray, a: Vec3, b: Vec3) -> Vec3:
    """Lane-select between two Vec3 batches (replaces branch divergence)."""
    return Vec3(
        jnp.where(mask, a.x, b.x),
        jnp.where(mask, a.y, b.y),
        jnp.where(mask, a.z, b.z),
    )


def is_nan(a: Vec3) -> jnp.ndarray:
    """ray_math.hpp:501 IsNaN: any component is NaN."""
    return jnp.isnan(a.x) | jnp.isnan(a.y) | jnp.isnan(a.z)


def gather(v: Vec3, idx: jnp.ndarray) -> Vec3:
    """Index a table-of-vectors by an int array (device gather)."""
    return Vec3(v.x[idx], v.y[idx], v.z[idx])


# --- minor reference-parity helpers (ray_math.hpp) --------------------------

def lerp1(a, b, t):
    """Lerp1f (ray_math.hpp:310-312)."""
    return (1.0 - t) * a + t * b


def smoothstep(a):
    """Smoothstep (ray_math.hpp:314-316): 3a^2 - 2a^3 (unused by the
    reference's render path; kept for math-library parity)."""
    return 3.0 * a * a - 2.0 * a * a * a


def gaussian(x, roughness):
    """Gaussian (ray_math.hpp:271-276), the reference's (unnormalized-
    in-its-own-way) bell curve: (1/(a/sqrt(2)/sqrt(pi))) * e^(-x^2/(2a^2))."""

    a = roughness
    sqrt_2, sqrt_pi = 1.41421356237, 1.77245385091
    return 1.0 / (a / sqrt_2 / sqrt_pi) * jnp.exp(-(x * x) / (2.0 * a * a))


def m2_inverse(a, b, c, d, tolerance: float = 1e-9):
    """2x2 inverse of column-vector matrix [[a, c], [b, d]] (ray_math.hpp
    m2/Inverse :123-168; unused by the reference's render path).
    Returns (ok, (ia, ib, ic, id))."""
    det = a * d - c * b
    ok = (det >= tolerance) | (det <= -tolerance)
    safe = jnp.where(ok, det, 1.0)
    return ok, (d / safe, -b / safe, -c / safe, a / safe)
