"""Scalar CPU oracle: an independent, loop-based implementation of the
reference algorithm used as the correctness anchor for the JAX renderer.

This is the role BASELINE.md assigns to "a scalar NumPy/CPU reference": a
straightforward per-pixel, per-sample, per-bounce port of the reference
semantics (RayCast win32_main.cpp:558-823, RayCastIntersect :406-556,
RenderTexel :990-1186) sharing NO code with the JAX integrator — including
the PRNG: the PCG4D counter streams are reimplemented below in pure numpy
(same published constants, independently written), so the golden gates also
cover utils/prng.py itself (a masking/bitcast/tag bug there cannot cancel
out of the comparison). Both sides consume identical streams keyed on
(pixel, sample, bounce, slot), so a device render and an oracle render of the
same configuration agree to float32 rounding, not just in distribution.
That is what makes the RMSE < 1e-3 golden gate meaningful.

Deliberately slow (python loops); use tiny images in tests.
"""

from __future__ import annotations

import math

import numpy as np

from ..scene.camera import Camera
from ..scene.schema import (
    HostMaterial, MAX_BOUNCE_COUNT, MIN_HIT_DISTANCE, MIN_ROUGHNESS, N_AIR,
    QUAD_MIN_HIT_DISTANCE, TOLERANCE, WorldBuilder,
    WORLD_RAYTRACING_ONE_WEEKEND, FIXED_FOCAL_LENGTH,
)
from ..render.raygen import POISSON_DISK, NUM_POISSON

F32 = np.float32
PI = F32(math.pi)

# --- counter PRNG, pure numpy (independent twin of utils/prng.py) -----------
# PCG4D (Jarzynski & Olano, JCGT 2020, listing 6) with the renderer's
# stream-tag layout. uint32 arithmetic wraps naturally in numpy arrays.

_TAG_JITTER = 0x0100_0000
_TAG_LENS = 0x0200_0000
_TAG_BOUNCE = 0x0400_0000
_BOUNCE_SLOTS = 8


def _pcg4d_np(a, b, c, d):
    u = np.uint32
    mul, inc = u(1664525), u(1013904223)
    a = a * mul + inc
    b = b * mul + inc
    c = c * mul + inc
    d = d * mul + inc
    a = a + b * d
    b = b + c * a
    c = c + a * b
    d = d + b * c
    a ^= a >> u(16)
    b ^= b >> u(16)
    c ^= c >> u(16)
    d ^= d >> u(16)
    a = a + b * d
    b = b + c * a
    c = c + a * b
    d = d + b * c
    return a, b, c, d


def _to_unit_np(x):
    """uint32 -> [0,1) float32 from the top 24 bits (matches prng._to_unit)."""
    return ((x >> np.uint32(8)) & np.uint32(0xFFFFFF)).astype(F32) * F32(1.0 / (1 << 24))


def _draw4_np(seed, pixel, sample, tag):
    with np.errstate(over="ignore"):  # uint32 wraparound is the algorithm
        a, b, c, d = _pcg4d_np(
            np.asarray(seed, np.uint32), np.asarray(pixel, np.uint32),
            np.asarray(sample, np.uint32), np.asarray(tag, np.uint32))
    return _to_unit_np(a), _to_unit_np(b), _to_unit_np(c), _to_unit_np(d)


def jitter_uniforms_np(seed, pixel, sample):
    a, b, _, _ = _draw4_np(seed, pixel, sample, _TAG_JITTER)
    return a, b


def lens_uniforms_np(seed, pixel, sample):
    a, b, _, _ = _draw4_np(seed, pixel, sample, _TAG_LENS)
    return a, b


def bounce_uniforms_np(seed, pixel, sample, bounce):
    base = np.uint32(_TAG_BOUNCE) + np.uint32(bounce) * np.uint32(2)
    a0, a1, a2, a3 = _draw4_np(seed, pixel, sample, base)
    b0, b1, b2, b3 = _draw4_np(seed, pixel, sample, base + np.uint32(1))
    return a0, a1, a2, a3, b0, b1, b2, b3


def v3(x, y, z):
    return np.array([x, y, z], F32)


def dot(a, b):
    return F32(a[0] * b[0] + a[1] * b[1] + a[2] * b[2])


def cross(a, b):
    return v3(a[1] * b[2] - b[1] * a[2],
              a[2] * b[0] - b[2] * a[0],
              a[0] * b[1] - b[0] * a[1])


def normalize(a):
    # multiply-by-reciprocal, matching the device op order (utils/vec.py)
    m = np.sqrt(dot(a, a))
    return a * (F32(1.0) / m)


# --- intersectors (scalar) --------------------------------------------------

def ray_sphere(o, d, center, r, min_hit):
    rel = o - center
    a = dot(d, d)
    b = F32(2.0) * dot(rel, d)
    c = dot(rel, rel) - F32(r) * F32(r)
    disc = b * b - F32(4.0) * a * c
    if disc < 0:
        return None
    root = np.sqrt(disc)
    if root <= TOLERANCE:
        return None
    t = (-b - root) / (F32(2.0) * a)
    if t <= min_hit:
        return None
    n = normalize(d * t + rel)
    return F32(t), n


def ray_plane(o, d, n, d_coef, min_hit):
    denom = dot(n, d)
    if -TOLERANCE <= denom <= TOLERANCE:
        return None
    return F32((F32(d_coef) - dot(n, o)) / denom)


def ray_planar(o, d, A, u, v, min_hit, quad):
    r = ray_planar_coords(o, d, A, u, v, min_hit, quad)
    return None if r is None else r[0]


def ray_planar_coords(o, d, A, u, v, min_hit, quad):
    """ray_planar + the hit's (alpha, beta) — the scalar twin of
    ops/intersect.ray_planar_triangle_uv, for uv interpolation."""
    n = cross(u, v)
    n_unit = normalize(n)
    d_coef = dot(A, n_unit)
    t = ray_plane(o, d, n_unit, d_coef, min_hit)
    if t is None:
        return None
    p = o + d * t - A
    w = n / dot(n, n)
    alpha = dot(w, cross(p, v))
    beta = dot(w, cross(u, p))
    if quad:
        ok = 0.0 <= alpha <= 1.0 and 0.0 <= beta <= 1.0
    else:
        ok = alpha >= 0.0 and beta >= 0.0 and (alpha + beta) <= 1.0
    if not ok or t <= min_hit:
        return None
    return t, alpha, beta


class HostWorld:
    """Scene accessor over the WorldBuilder lists."""

    def __init__(self, b: WorldBuilder):
        self.materials = b.materials
        self.spheres = [(v3(*c), F32(r), m) for (c, r, m) in b.spheres]
        self.quads = [(v3(*p), v3(*u), v3(*v), m) for (p, u, v, m) in b.quads]
        self.planes = [(v3(*n), F32(d), m) for (n, d, m) in b.planes]
        if b.triangles is not None:
            self.tris = [
                (b.triangles[i, 0].astype(F32),
                 (b.triangles[i, 1] - b.triangles[i, 0]).astype(F32),
                 (b.triangles[i, 2] - b.triangles[i, 0]).astype(F32),
                 int(b.tri_mats[i]))
                for i in range(len(b.triangles))
            ]
            # per-triangle uv triples (mesh-UV scenes, set_mesh uvs)
            uvs = getattr(b, "tri_uvs", None)
            self.tri_uvs = (None if uvs is None
                            else [uvs[i].astype(F32)
                                  for i in range(len(uvs))])
        else:
            self.tris = []
            self.tri_uvs = None
        self.textures = b.textures
        self.quad_light = b.quad_light  # -1, or NEE targets this quad
        self.fog = b.fog  # (sigma_t, albedo3, g); sigma_t 0 = no medium
        self.tbn_normal_maps = getattr(b, "tbn_normal_maps", False)

    def intersect(self, o, d):
        """RayCastIntersect order: spheres, quads, planes, triangles.
        Returns (t, mat, normal, uv) — uv is the winning triangle's
        interpolated texcoord (mesh-UV scenes) or None."""
        best_t, best_mat, best_n = np.float32(np.finfo(np.float32).max), 0, v3(0, 0, 0)
        best_uv = None
        for (c, r, m) in self.spheres:
            res = ray_sphere(o, d, c, r, MIN_HIT_DISTANCE)
            if res is not None and res[0] < best_t:
                best_t, best_mat, best_n = res[0], m, res[1]
        for (p, u, v, m) in self.quads:
            n = normalize(cross(u, v))
            t = ray_planar(o, d, p, u, v, QUAD_MIN_HIT_DISTANCE, quad=True)
            if t is not None and t < best_t:
                best_t, best_mat, best_n = t, m, n
        for (n, dc, m) in self.planes:
            t = ray_plane(o, d, n, dc, MIN_HIT_DISTANCE)
            if t is not None and t > MIN_HIT_DISTANCE and t < best_t:
                best_t, best_mat, best_n = t, m, n
        for ti, (A, u, v, m) in enumerate(self.tris):
            r = ray_planar_coords(o, d, A, u, v, MIN_HIT_DISTANCE, quad=False)
            if r is not None and r[0] < best_t:
                best_t, best_mat, best_n = r[0], m, normalize(cross(u, v))
                if self.tri_uvs is not None:
                    uvt = self.tri_uvs[ti]  # (3, 2): uv at A, B, C
                    # uv0 + alpha*(uv1-uv0) + beta*(uv2-uv0), f32 order
                    # matching intersect_scene_uv
                    best_uv = (
                        uvt[0, 0] + r[1] * (uvt[1, 0] - uvt[0, 0])
                        + r[2] * (uvt[2, 0] - uvt[0, 0]),
                        uvt[0, 1] + r[1] * (uvt[1, 1] - uvt[0, 1])
                        + r[2] * (uvt[2, 1] - uvt[0, 1]),
                    )
        return best_t, best_mat, best_n, best_uv


# --- samplers (scalar, consuming explicit uniforms) --------------------------

def cosine_hemisphere(u1, u2):
    phi = F32(2.0) * PI * F32(u1)
    sq = np.sqrt(F32(u2))
    return v3(np.cos(phi) * sq, np.sin(phi) * sq, np.sqrt(F32(1.0) - F32(u2)))


def ggx_half_vector(u1, u2, roughness):
    a2 = F32(roughness) ** 4
    phi = F32(2.0) * PI * F32(u1)
    ct = np.sqrt((F32(1.0) - F32(u2)) / (F32(1.0) + F32(u2) * (a2 - F32(1.0))))
    st = np.sqrt(max(F32(0.0), F32(1.0) - ct * ct))
    return v3(np.cos(phi) * st, np.sin(phi) * st, ct)


def to_sphere(u1, u2, center, radius, origin):
    dist2 = dot(origin - center, origin - center)
    term1 = F32(1.0) - F32(radius) * F32(radius) / dist2
    if term1 < 0.0:
        return None
    z = F32(1.0) + F32(u2) * (np.sqrt(term1) - F32(1.0))
    term2 = max(F32(0.0), F32(1.0) - z * z)
    phi = F32(2.0) * PI * F32(u1)
    s = np.sqrt(term2)
    return v3(np.cos(phi) * s, np.sin(phi) * s, z)


def orthonormal_basis(w):
    unit_w = normalize(w)
    a = v3(0, 1, 0) if abs(unit_w[0]) > 0.9 else v3(1, 0, 0)
    vv = normalize(cross(unit_w, a))
    uu = cross(unit_w, vv)
    return uu, vv, unit_w


def pdf_cosine(d):
    return max(F32(0.0), d[2]) / PI


def henyey_greenstein_sample(u1, u2, g):
    """Scalar twin of ops/sampling.henyey_greenstein_sample (tangent
    space, +z = propagation direction)."""
    g = F32(g)
    if abs(g) < 1e-3:
        ct = F32(1.0) - F32(2.0) * F32(u1)
    else:
        s = (F32(1.0) - g * g) / (F32(1.0) - g + F32(2.0) * g * F32(u1))
        ct = (F32(1.0) + g * g - s * s) / (F32(2.0) * g)
    ct = F32(min(max(float(ct), -1.0), 1.0))
    r = np.sqrt(max(F32(0.0), F32(1.0) - ct * ct))
    phi = F32(2.0) * PI * F32(u2)
    return v3(np.cos(phi) * r, np.sin(phi) * r, ct)


def pdf_henyey_greenstein(cos_t, g):
    """Scalar twin of ops/sampling.pdf_henyey_greenstein."""
    g = F32(g)
    if abs(g) < 1e-3:
        return F32(1.0) / (F32(4.0) * PI)
    denom = max(F32(1e-12), F32(1.0) + g * g - F32(2.0) * g * F32(cos_t))
    inv = F32(1.0) / np.sqrt(denom)
    return (F32(1.0) - g * g) * inv * inv * inv / (F32(4.0) * PI)


def pdf_to_sphere(world, o, d, center, radius):
    if ray_sphere(o, d, center, radius, MIN_HIT_DISTANCE) is None:
        return F32(0.0)
    dist2 = dot(o - center, o - center)
    ctm = np.sqrt(max(F32(0.0), F32(1.0) - F32(radius) ** 2 / dist2))
    sa = F32(2.0) * PI * (F32(1.0) - ctm)
    return F32(1.0) / sa if sa > 0 else F32(0.0)


def pdf_quad(o, d, qp, qu, qv):
    """Scalar twin of ops/sampling.pdf_quad: 0 unless the ray hits the
    quad at t > MIN_HIT_DISTANCE (the plain constant, NOT the dispatcher's
    0.02 quad quirk), else dist^2 / (cos * area). Like the device twin it
    FIXES the reference PdfValueQuad's unnormalized-normal cosine
    (win32_main.cpp:317-320 divides by cos*area^2; see sampling.pdf_quad's
    docstring)."""
    t = ray_planar(o, d, qp, qu, qv, MIN_HIT_DISTANCE, quad=True)
    if t is None:
        return F32(0.0)
    n = cross(qu, qv)
    area = F32(np.sqrt(dot(n, n)))
    mag = F32(np.sqrt(dot(d, d)))
    dist2 = t * t * mag * mag
    cosine = abs(dot(d, n)) / (mag * area)
    return F32(dist2 / (cosine * area)) if cosine * area > 0 else F32(0.0)


def refract_np(d, N, nglass):
    """Scalar Snell refraction with TIR (None) — the independent twin of
    ops/shade.find_refraction_direction (win32_main.cpp:1628-1661)."""
    nair = F32(1.008)
    if dot(N, d) < 0.0:
        n1, n2 = nair, nglass
        Nf = -N
    else:
        n1, n2 = nglass, nair
        Nf = N
    cos1 = F32(min(max(float(dot(Nf, d)), -1.0), 1.0))
    # trig-free Snell, mirroring ops/shade.find_refraction_direction
    sin1 = F32(np.sqrt(max(F32(1.0) - cos1 * cos1, F32(0.0))))
    lhs = F32(n1 / n2) * sin1
    if lhs > 1.0:
        return None
    cos2 = F32(np.sqrt(max(F32(1.0) - lhs * lhs, F32(0.0))))
    M = normalize(cross(Nf, cross(d, Nf)))
    return cos2 * Nf + lhs * M


def schlick_metal(F0, cos_theta, metalness, surface_color):
    vF0 = np.full(3, F0, F32)
    vF0 = vF0 * (F32(1.0) - F32(metalness)) + np.asarray(surface_color, F32) * F32(metalness)
    return vF0 + F32((1.0 - cos_theta) ** 5) * (np.ones(3, F32) - vF0)


def hammon(N, L, V, roughness):
    a2 = F32(roughness) ** 4
    nv, nl = dot(N, V), dot(N, L)
    num = F32(2.0) * nl * nv
    den = nv * np.sqrt(a2 + (F32(1.0) - a2) * nl * nl) + \
        nl * np.sqrt(a2 + (F32(1.0) - a2) * nv * nv)
    return num / den


def sample_texture_host(tex, u, v):
    """Float32-exact bilinear-wrap sampling, op-order identical to the device
    sampler (ops/texture.py) so texel selection never diverges."""
    h, w = tex.shape[:2]
    u, v = abs(F32(u)), abs(F32(v))
    x1, y1 = int(u), int(v)
    s = min(F32(1.0), max(u - F32(x1), F32(0.0)))
    t = min(F32(1.0), max(v - F32(y1), F32(0.0)))
    x1, y1 = x1 % w, y1 % h
    x2, y2 = (x1 + 1) % w, (y1 + 1) % h
    top = (F32(1.0) - s) * tex[y1, x1] + s * tex[y1, x2]
    bot = (F32(1.0) - s) * tex[y2, x1] + s * tex[y2, x2]
    return ((F32(1.0) - t) * top + t * bot).astype(F32)


def bespoke_sample_host(tex, u, v):
    h, w = tex.shape[:2]
    return sample_texture_host(tex, F32(u) * F32(w) * F32(0.5),
                               F32(v) * F32(h) * F32(0.5))


def _mip_lod(t, cos_theta, k, n_levels):
    """Scalar twin of the device LOD rule (integrator.shade_bounce, opt-in
    via mip_scale): fp = t * k / max(|cos|, 0.1) with k the f32-rounded
    mip_scale * w0 * 0.5 constant; lod = floor(log2(fp)) clamped to the
    pyramid via the same threshold sweep the renderer unrolls."""
    fp = F32(t) * k / max(abs(F32(cos_theta)), F32(0.1))
    lod = 0
    for lk in range(1, n_levels):
        if fp >= F32(2.0 ** lk):
            lod += 1
    return lod


# --- the integrator ----------------------------------------------------------

def trace_path(world: HostWorld, o, d, u_bounce, just_cosine,
               use_metalness_maps=True, use_roughness_maps=True,
               use_normal_maps=True, just_importance=False,
               use_russian_roulette=False, mip=None):
    """Iterative equivalent of RayCast(world, o, d, 0) consuming
    u_bounce[(bounce, slot)] uniforms. Kills zero-pdf / degenerate draws
    instead of retrying (same policy as the JAX integrator)."""
    radiance = np.zeros(3, F32)
    throughput = np.ones(3, F32)
    light = world.spheres[0] if world.spheres else None

    for b in range(MAX_BOUNCE_COUNT):
        t, mat_i, N, hit_uv = world.intersect(o, d)

        fog_sigma, fog_albedo, fog_g = world.fog
        if fog_sigma > 0.0:
            # Volume event twin (integrator.shade_bounce fog block):
            # free flight s = -ln(1-u5)/sigma_t; scatter when it undercuts
            # the surface hit. Same slots: u[5] distance, u[1] mixture
            # coin, u[2]/u[3] direction, u[4] RR.
            u = u_bounce[b]
            s = -np.log(max(F32(1.0) - F32(u[5]), F32(1e-30))) \
                / F32(fog_sigma)
            if s < t:
                if b == MAX_BOUNCE_COUNT - 1:
                    return radiance
                vp = o + d * s
                use_phase = u[1] > 0.5
                if use_phase:
                    ph = henyey_greenstein_sample(u[2], u[3], fog_g)
                    fx, fy, fz = orthonormal_basis(d)
                    L = normalize(ph[0] * fx + ph[1] * fy + ph[2] * fz)
                elif world.quad_light >= 0:
                    qp, qu_, qv_, _ = world.quads[world.quad_light]
                    L = normalize(qp + qu_ * F32(u[2]) + qv_ * F32(u[3])
                                  - vp)
                else:
                    light_s = world.spheres[0]
                    r_dir = to_sphere(u[2], u[3], light_s[0], light_s[1], vp)
                    if r_dir is None:
                        return radiance  # kill (imp_ok gate)
                    gx, gy, gz = orthonormal_basis(light_s[0] - vp)
                    L = normalize(r_dir[0] * gx + r_dir[1] * gy
                                  + r_dir[2] * gz)
                f_p = pdf_henyey_greenstein(dot(d, L), fog_g)
                if world.quad_light >= 0:
                    qp, qu_, qv_, _ = world.quads[world.quad_light]
                    p_light = pdf_quad(vp, L, qp, qu_, qv_)
                else:
                    light_s = world.spheres[0]
                    p_light = pdf_to_sphere(world, vp, L, light_s[0],
                                            light_s[1])
                px = F32(0.5) * f_p + F32(0.5) * p_light
                if px == 0.0:
                    return radiance
                w = f_p * (F32(1.0) / px)
                # parenthesized like hadamard(throughput, w * albedo)
                new_thr = throughput * (np.asarray(fog_albedo, F32) * w)
                if use_russian_roulette and b >= 1:
                    q = F32(min(max(float(new_thr.max()), 0.05), 1.0))
                    if not (u[4] < q):
                        return radiance
                    new_thr = new_thr * (F32(1.0) / q)
                throughput = new_thr
                o, d = vp, L
                continue

        mat: HostMaterial = world.materials[mat_i]
        emit = np.asarray(mat.emit, F32)
        radiance = radiance + throughput * emit
        if mat_i == 0 or np.any(emit != 0.0):
            return radiance
        if b == MAX_BOUNCE_COUNT - 1:
            return radiance

        cos_theta = dot(N, d)
        if cos_theta > 0:
            cos_theta = dot(-N, d)
        hitpoint = o + d * t
        pure_bounce = d - N * (F32(2.0) * cos_theta)
        V = -d

        # opt-in mip selection (``mip`` = (k_const, chains); twin of the
        # integrator's lod sweep — one level per bounce, all maps)
        if mip is not None and world.textures:
            _lod = _mip_lod(t, cos_theta, mip[0], len(mip[1][0]))
            texs = [chain[_lod] for chain in mip[1]]
        else:
            texs = world.textures

        u = u_bounce[b]
        if mat.transmission > 0.0:
            # delta dielectric (mirrors integrator.shade_bounce's
            # any_transmissive branch exactly): Schlick coin on u[0],
            # refract via the geometric normal, TIR -> reflect,
            # weight = albedo, RR on the same slot
            ior_t = F32(mat.ior)
            ch = None
            if mat.dispersion > 0.0:
                # spectral channel twin (integrator dispersive lobe):
                # coin u[6], ior + dispersion*(c-1), channel mask x3
                ch = min(int(F32(u[6]) * F32(3.0)), 2)
                ior_t = F32(mat.ior) + F32(mat.dispersion) * F32(ch - 1)
            F0t = F32(((N_AIR - ior_t) / (N_AIR + ior_t)) ** 2)
            cos_i = F32(-cos_theta)
            t1 = F32(1.0) - F32(min(max(float(cos_i), 0.0), 1.0))
            t2 = t1 * t1
            t5 = t2 * t2 * t1  # XLA integer_pow(5) expansion order
            fres = F0t + (F32(1.0) - F0t) * t5
            refr = refract_np(d, N, ior_t)
            # sign-safe true mirror (pure_bounce is only a mirror for front
            # faces; interior TIR hits are back-facing) — twin of the
            # integrator's `mirror`
            mirror = d - N * (F32(2.0) * dot(N, d))
            L = mirror if (u[0] < fres or refr is None) else refr
            albedo = np.asarray(mat.albedo, F32)
            if world.textures and mat.albedo_idx != 0:
                albedo = bespoke_sample_host(
                    texs[mat.albedo_idx - 1],
                    hitpoint[0], hitpoint[1])
            if hit_uv is not None and mat.albedo_idx != 0:
                # mesh-UV twin: texel MODULATES the material albedo
                albedo = np.asarray(mat.albedo, F32) * sample_texture_host(
                    texs[mat.albedo_idx - 1], hit_uv[0], hit_uv[1])
            if ch is not None:
                mask = np.zeros(3, F32)
                mask[ch] = F32(3.0)
                albedo = albedo * mask
            new_thr = throughput * albedo
            if use_russian_roulette and b >= 1:
                q = F32(min(max(float(new_thr.max()), 0.05), 1.0))
                if not (u[4] < q):
                    return radiance
                new_thr = new_thr * (F32(1.0) / q)
            throughput = new_thr
            o, d = hitpoint, L
            continue

        metalness = F32(mat.metalness)
        roughness = F32(mat.roughness)
        if world.textures:
            if use_metalness_maps and mat.metalness_idx != 0:
                metalness = bespoke_sample_host(
                    texs[mat.metalness_idx - 1], hitpoint[0], hitpoint[1])[0]
            if use_roughness_maps and mat.roughness_idx != 0:
                roughness = bespoke_sample_host(
                    texs[mat.roughness_idx - 1], hitpoint[0], hitpoint[1])[0]
            if use_normal_maps and mat.normal_idx != 0:
                nt = bespoke_sample_host(
                    texs[mat.normal_idx - 1], hitpoint[0], hitpoint[1])
                n_dec = F32(2.0) * nt - np.ones(3, F32)
                if getattr(world, "tbn_normal_maps", False):
                    # tangent-frame twin (integrator tbn_normal_maps)
                    bu, bv, bw = orthonormal_basis(N)
                    n_dec = n_dec[0] * bu + n_dec[1] * bv + n_dec[2] * bw
                N = normalize(n_dec)
            if getattr(mat, "bump_idx", 0) != 0:
                # bump-map twin (integrator any_bump block)
                beps = F32(0.01)
                bt = texs[mat.bump_idx - 1]
                h0 = bespoke_sample_host(bt, hitpoint[0], hitpoint[1])[0]
                hx = bespoke_sample_host(bt, hitpoint[0] + beps,
                                         hitpoint[1])[0]
                hy = bespoke_sample_host(bt, hitpoint[0],
                                         hitpoint[1] + beps)[0]
                gx = (hx - h0) / beps * F32(mat.bump_scale)
                gy = (hy - h0) / beps * F32(mat.bump_scale)
                N = normalize(v3(N[0] - gx, N[1] - gy, N[2]))

        ndotv = dot(N, V)
        if ndotv <= 0.0:
            return radiance

        tx, ty, tz = orthonormal_basis(N)
        u = u_bounce[b]
        b_specular = u[0] > 0.5
        b_sample_cosine = u[1] > 0.5
        smooth = roughness < MIN_ROUGHNESS

        H = None
        if b_specular and smooth:
            L = pure_bounce
            px = F32(1.0)
        elif not b_specular:
            use_cos = just_cosine or (b_sample_cosine and not just_importance)
            if world.quad_light >= 0:
                # quad-light NEE twin (integrator.shade_bounce quad branch)
                qp, qu_, qv_, _ = world.quads[world.quad_light]
                if use_cos:
                    r_dir = cosine_hemisphere(u[2], u[3])
                    L = normalize(r_dir[0] * tx + r_dir[1] * ty + r_dir[2] * tz)
                    pcos = pdf_cosine(r_dir)
                else:
                    target = qp + qu_ * u[2] + qv_ * u[3] - hitpoint
                    L = normalize(target)
                    pcos = max(F32(0.0), dot(N, L)) / PI
                pimp = pdf_quad(hitpoint, L, qp, qu_, qv_)
                H = normalize(L + V)
                if just_cosine:
                    px = pcos
                elif just_importance:
                    px = pimp
                else:
                    px = F32(0.5) * pcos + F32(0.5) * pimp
                if px == 0.0:
                    return radiance  # kill (reference retries)
            else:
                if use_cos:
                    r_dir = cosine_hemisphere(u[2], u[3])
                    frame = (tx, ty, tz)
                else:
                    direction = light[0] - hitpoint
                    r_dir = to_sphere(u[2], u[3], light[0], light[1], hitpoint)
                    if r_dir is None:
                        return radiance  # kill (reference retries)
                    frame = orthonormal_basis(direction)
                L = normalize(r_dir[0] * frame[0] + r_dir[1] * frame[1] + r_dir[2] * frame[2])
                H = normalize(L + V)
                if just_cosine:
                    px = pdf_cosine(r_dir)
                elif just_importance:
                    px = pdf_to_sphere(world, hitpoint, L, light[0], light[1])
                else:
                    px = F32(0.5) * pdf_cosine(r_dir) + \
                        F32(0.5) * pdf_to_sphere(world, hitpoint, L, light[0], light[1])
                if px == 0.0:
                    return radiance  # kill (reference retries)
        else:
            r_dir = ggx_half_vector(u[2], u[3], roughness)
            H = normalize(r_dir[0] * tx + r_dir[1] * ty + r_dir[2] * tz)
            L = H * (F32(2.0) * dot(V, H)) - V
            px = F32(1.0)

        ndotl = dot(N, L)
        if ndotl <= 0.0:
            return radiance

        F0 = F32(((N_AIR - mat.ior) / (N_AIR + mat.ior)) ** 2)
        if smooth:
            ks = schlick_metal(F0, ndotl, metalness, mat.metal_color)
        else:
            if not (dot(H, V) > 0.0 and dot(H, L) > 0.0):
                return radiance
            ks = schlick_metal(F0, dot(H, L), metalness, mat.metal_color)
        kd = (np.ones(3, F32) - ks) * (F32(1.0) - metalness)

        if b_specular and smooth:
            brdf = ks
        elif b_specular:
            spec = hammon(N, L, V, roughness) * abs(dot(H, L)) / abs(dot(N, L)) / abs(dot(H, N))
            brdf = ks * spec
        else:
            albedo = np.asarray(mat.albedo, F32)
            if world.textures and mat.albedo_idx != 0:
                albedo = bespoke_sample_host(
                    texs[mat.albedo_idx - 1], hitpoint[0], hitpoint[1])
            if hit_uv is not None and mat.albedo_idx != 0:
                # mesh-UV twin (integrator uv branch): MODULATES
                albedo = np.asarray(mat.albedo, F32) * sample_texture_host(
                    texs[mat.albedo_idx - 1], hit_uv[0], hit_uv[1])
            brdf = ndotl * kd * albedo / PI

        new_thr = throughput * (F32(2.0) / px) * brdf
        if use_russian_roulette and b >= 1:
            # mirror integrator.russian_roulette exactly (same u[4] slot)
            q = F32(min(max(float(new_thr.max()), 0.05), 1.0))
            if not (u_bounce[b][4] < q):
                return radiance
            new_thr = new_thr * (F32(1.0) / q)
        throughput = new_thr
        o, d = hitpoint, L

    return radiance


def render_oracle(
    builder: WorldBuilder,
    camera: Camera,
    width: int,
    height: int,
    pp: int,
    seed: int = 0,
    world_kind: int = 0,
    use_normal_maps: bool = True,
    use_metalness_maps: bool = True,
    use_roughness_maps: bool = True,
    use_russian_roulette: bool = False,
    mip_scale: float = 0.0,
    row_range=None,
) -> np.ndarray:
    """Full oracle render -> (H, W, 3) float32 mean radiance (pre-tonemap).

    ``row_range`` (an iterable of y indices) renders only those rows and
    returns a (len(row_range), W, 3) band — geometry, streams and pixel
    indices stay GLOBAL (p = y*width+x), so bands computed by parallel
    worker processes assemble bit-identically to a whole-frame render
    (bench.py --rmse uses this to afford the 720p north-star gate).

    ``mip_scale`` > 0 enables the opt-in mip twin (RenderConfig.mip_scale):
    per-texture decimation chains (textures.generate_mipmap_chain semantics)
    plus the renderer's f32 LOD constant. Callers must only pass it for
    scenes where the device built a pyramid (square pow2 combined set,
    schema.WorldBuilder.finalize)."""
    world = HostWorld(builder)
    mip = None
    if mip_scale and world.textures:
        from ..scene.textures import generate_mipmap_chain
        w0 = world.textures[0].shape[1]
        # one double-precision product rounded ONCE to f32 — the identical
        # constant the integrator bakes (integrator.shade_bounce `k`)
        mip = (F32(np.float32(mip_scale * w0 * 0.5)),
               [generate_mipmap_chain(t) for t in world.textures])
    just_cosine = world_kind == WORLD_RAYTRACING_ONE_WEEKEND
    n_pix = width * height
    spp = pp * pp

    # Precompute the uniform streams from the pure-numpy PCG4D twin (same
    # counters the JAX renderer hashes on device; no jax on this side).
    pixel_idx = np.arange(n_pix, dtype=np.uint32)
    jit_u = np.zeros((n_pix, spp, 2), np.float32)
    bnc_u = np.zeros((n_pix, spp, MAX_BOUNCE_COUNT, _BOUNCE_SLOTS), np.float32)
    lens_u = np.zeros((n_pix, pp, 2), np.float32)
    for s in range(spp):
        jit_u[:, s] = np.stack(jitter_uniforms_np(seed, pixel_idx, s), -1)
        # ALL bounces, including the terminal one: pre-fog nothing sampled
        # there, but the volume event consumes u[5] at every depth
        for b in range(MAX_BOUNCE_COUNT):
            bnc_u[:, s, b] = np.stack(
                bounce_uniforms_np(seed, pixel_idx, s, b), -1)
    for ri in range(pp):
        lens_u[:, ri] = np.stack(lens_uniforms_np(seed, pixel_idx, ri), -1)

    cam = camera
    img = np.zeros((height, width, 3), np.float32)
    pos = v3(*cam.pos)
    fc = v3(*cam.frustum_center)
    ax, ay = v3(*cam.axis_x), v3(*cam.axis_y)

    rows = range(height) if row_range is None else list(row_range)
    if row_range is not None:
        img = np.zeros((len(rows), width, 3), np.float32)
    for yi, y in enumerate(rows):
        fy = F32(-1.0 + 2.0 * y / height)
        for x in range(width):
            fx = F32(-1.0 + 2.0 * x / width)
            p = y * width + x
            color = np.zeros(3, F32)
            valid = 0
            if cam.use_pinhole:
                hpw, hph = F32(cam.half_film_pixel_w), F32(cam.half_film_pixel_h)
                step_x = F32(1.0 / pp) * hpw * F32(2.0)
                step_y = F32(1.0 / pp) * hph * F32(2.0)
                for i in range(pp):
                    for j in range(pp):
                        s = i * pp + j
                        ux, uy = jit_u[p, s]
                        x_step = (fx - hpw) + F32(i / pp) * hpw + F32(0.5) * step_x \
                            + (F32(ux) - F32(0.5)) * step_x
                        y_step = (fy - hph) + F32(j / pp) * hph + F32(0.5) * step_y \
                            + (F32(uy) - F32(0.5)) * step_y
                        fp = fc + (x_step * F32(cam.half_film_width)) * ax \
                            + (y_step * F32(cam.half_film_height)) * ay
                        d = normalize(fp - pos)
                        rad = trace_path(world, pos, d, bnc_u[p, s], just_cosine,
                                         use_metalness_maps, use_roughness_maps,
                                         use_normal_maps,
                                         use_russian_roulette=use_russian_roulette,
                                         mip=mip)
                        if np.any(np.isnan(rad)):
                            continue
                        color += rad
                        valid += 1
            else:
                focal_plane_dist = F32(1.0 / (1.0 / FIXED_FOCAL_LENGTH
                                              - 1.0 / cam.focal_length))
                azv = v3(*cam.axis_z)
                nrm = -azv
                plane_point = pos + ax + focal_plane_dist * nrm
                d_coef = dot(nrm, plane_point)
                for ri in range(pp):
                    ux, uy = lens_u[p, ri]
                    off_x = fx + (F32(2.0) * F32(ux) - F32(1.0)) * F32(cam.half_film_pixel_w)
                    off_y = fy + (F32(2.0) * F32(uy) - F32(1.0)) * F32(cam.half_film_pixel_h)
                    fp = fc + (off_x * F32(cam.half_film_width)) * ax \
                        + (off_y * F32(cam.half_film_height)) * ay
                    rd = normalize(fp - pos)
                    t = (d_coef - dot(nrm, pos)) / dot(nrm, rd)
                    focal_point = pos + rd * t
                    for rj in range(pp):
                        s = ri * pp + rj
                        dsk = POISSON_DISK[(rj * ri) % NUM_POISSON]
                        od = pos + F32(dsk[0] * cam.aperture_radius) * ax \
                            + F32(dsk[1] * cam.aperture_radius) * ay
                        dd = normalize(focal_point - od)
                        rad = trace_path(world, od, dd, bnc_u[p, s], just_cosine,
                                         use_metalness_maps, use_roughness_maps,
                                         use_normal_maps,
                                         use_russian_roulette=use_russian_roulette,
                                         mip=mip)
                        if np.any(np.isnan(rad)):
                            continue
                        color += rad
                        valid += 1
            img[yi, x] = color / max(valid, 1)
    return img
