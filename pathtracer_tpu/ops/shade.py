"""BSDF library: Fresnel, masking-shadowing, GGX D, diffuse/specular terms.

Batched translations of the reference BSDF set:
- SchlickMetal            (win32_main.cpp:1752-1756)
- GGX (D term)            (win32_main.cpp:1758-1770; only ever used via its
                           cancellation against the GGX sampling PDF,
                           comment at :767-770 — provided & tested anyway)
- HammonMaskingShadowing  (win32_main.cpp:1773-1781)
- BrdfDiff                (win32_main.cpp:1595-1608): albedo/pi or texture/pi
- BrdfSpecular            (win32_main.cpp:1610-1620): Hammon * |H.L|/(|N.L||H.N|)
- EffectivelySmooth       (win32_main.cpp:1783-1786): roughness < 0.01
- FindRefractionDirection (win32_main.cpp:1628-1661): Snell + TIR; unused by
  the reference's main path (refraction listed as in-progress) but part of
  the API surface.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from ..ops.sampling import PI, burley_alpha2
from ..scene.schema import MIN_ROUGHNESS
from ..utils.vec import Vec3, cross, dot, lerp, normalize, splat


def effectively_smooth(roughness: jnp.ndarray) -> jnp.ndarray:
    return roughness < MIN_ROUGHNESS


def schlick_metal(F0: jnp.ndarray, cos_theta: jnp.ndarray,
                  metalness: jnp.ndarray, surface_color: Vec3) -> Vec3:
    """Schlick Fresnel with metal tint: F0 lerped toward the metal color by
    metalness, then F0 + (1-cos)^5 (1-F0) per channel."""
    shape = jnp.shape(cos_theta)
    vF0 = lerp(splat((1.0, 1.0, 1.0), shape) * F0, surface_color, metalness)
    # (1-cos)^5 as multiplies, not pow (a transcendental)
    m = 1.0 - cos_theta
    m2 = m * m
    p = m2 * m2 * m
    one = splat((1.0, 1.0, 1.0), shape)
    return Vec3(
        vF0.x + p * (one.x - vF0.x),
        vF0.y + p * (one.y - vF0.y),
        vF0.z + p * (one.z - vF0.z),
    )


def ggx_d(N: Vec3, H: Vec3, roughness: jnp.ndarray) -> jnp.ndarray:
    """Trowbridge-Reitz D with Burley a2=r^4; returns 1 where the denominator
    vanishes (the reference's "what's the proper thing here?" guard)."""
    a2 = burley_alpha2(roughness)
    ndoth = dot(N, H)
    denom = 1.0 + ndoth * ndoth * (a2 - 1.0)
    denom = PI * denom * denom
    return jnp.where(denom == 0.0, 1.0, a2 / jnp.where(denom == 0.0, 1.0, denom))


def hammon_masking_shadowing(N: Vec3, L: Vec3, V: Vec3, roughness: jnp.ndarray) -> jnp.ndarray:
    """Hammon's Smith-joint approximation (GDC); assumes NdotL, NdotV > 0."""
    a2 = burley_alpha2(roughness)
    ndotv = dot(N, V)
    ndotl = dot(N, L)
    num = 2.0 * ndotl * ndotv
    den = ndotv * jnp.sqrt(a2 + (1.0 - a2) * ndotl * ndotl) + \
        ndotl * jnp.sqrt(a2 + (1.0 - a2) * ndotv * ndotv)
    return num / jnp.where(den == 0.0, 1.0, den)


def brdf_specular_scalar(N: Vec3, L: Vec3, V: Vec3, H: Vec3,
                         roughness: jnp.ndarray) -> jnp.ndarray:
    """The scalar factor of BrdfSpecular (win32_main.cpp:1610-1620): the GGX
    D term cancels against its sampling PDF so what remains is
    Hammon * |H.L| / (|N.L| |H.N|). Multiply into ks per channel."""
    g = hammon_masking_shadowing(N, L, V, roughness)
    denom = jnp.abs(dot(N, L)) * jnp.abs(dot(H, N))
    return g * jnp.abs(dot(H, L)) / jnp.where(denom == 0.0, 1.0, denom)


def find_refraction_direction(ray_dir: Vec3, N: Vec3, nglass: jnp.ndarray
                              ) -> Tuple[Vec3, jnp.ndarray]:
    """Snell refraction with total-internal-reflection detection
    (win32_main.cpp:1628-1661). Returns (dir, refracted_mask)."""
    nair = 1.008
    into = dot(N, ray_dir) < 0.0
    n1 = jnp.where(into, nair, nglass)
    n2 = jnp.where(into, nglass, nair)
    Nf = Vec3(
        jnp.where(into, -N.x, N.x),
        jnp.where(into, -N.y, N.y),
        jnp.where(into, -N.z, N.z),
    )
    cos1 = jnp.clip(dot(Nf, ray_dir), -1.0, 1.0)
    # trig-free Snell (sin(acos(x)) = sqrt(1-x^2), cos(asin(x)) =
    # sqrt(1-x^2) on the relevant branches): no acos/asin round trip
    sin1 = jnp.sqrt(jnp.maximum(1.0 - cos1 * cos1, 0.0))
    lhs = n1 / n2 * sin1
    ok = lhs <= 1.0
    lhs_c = jnp.clip(lhs, 0.0, 1.0)
    cos2 = jnp.sqrt(jnp.maximum(1.0 - lhs_c * lhs_c, 0.0))
    M = normalize(cross(Nf, cross(ray_dir, Nf)), eps=1e-30)
    out = Vec3(
        cos2 * Nf.x + lhs * M.x,
        cos2 * Nf.y + lhs * M.y,
        cos2 * Nf.z + lhs * M.z,
    )
    return out, ok
