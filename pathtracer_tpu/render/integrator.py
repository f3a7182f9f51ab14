"""Wavefront path integrator: bounce stepping over SoA ray batches.

The reference integrator is a recursive megakernel (`RayCast`,
win32_main.cpp:558-823) with divergent control flow. Recursion and
divergence don't map to XLA, so this renderer restructures it as an
*iterative throughput accumulation*. Unrolling the observation

    RayCast(depth) = emit(depth) + w(depth) * RayCast(depth+1),
    w = 2 * (1/px) * brdfTerm                      (win32_main.cpp:780-782)

gives   radiance = sum_b [ prod_{k<b} w(k) ] * emit(b),

evaluated with masked lanes instead of branches. Two drivers share the
single-sourced per-bounce shading step (:func:`shade_bounce`):

- :func:`trace` — the unrolled 4-bounce loop (supports every debug render
  kind; the oracle-comparison reference path);
- render/wavefront.py — the persistent path-regeneration loop (terminated
  lanes immediately start their pixel's next sample, ~100% lane utilization;
  the production/throughput path). Both produce bit-identical radiance per
  (pixel, sample) because randomness is a pure function of those counters.

Estimator semantics preserved exactly:
- 50/50 estimator split with the x2 correction weight (win32_main.cpp:661-670);
- mirror path for EffectivelySmooth surfaces, px=1 (:672-675);
- diffuse estimator = 50/50 mixture of cosine-hemisphere and
  emissive-sphere solid-angle sampling with mixture PDF
  px = 0.5*PdfCos + 0.5*PdfSphere (:676-722), the important light being
  spheres[0] (:683), and the reference quirk that PdfCos is evaluated on the
  raw sample in *whichever* tangent frame produced it (:709);
- GGX half-vector sampling with the D/pdf cancellation, px=1 (:724-731);
- SchlickMetal Fresnel; kd = (1-ks)(1-metalness) (:738-759);
- world 4 forces cosine-only sampling (:654-655).

Divergences from the reference (documented, intentional):
- the reference *retries* an estimator draw whose pdf is 0 or whose
  to-sphere sample degenerates (`continue`, :700,:722); such lanes are
  measure-zero — we kill them (weight 0) instead of looping;
- NaN radiance is masked out by the accumulator (renderer.py) rather than
  resampled (:1068), keeping the estimator deterministic per (pixel,sample);
- optional Russian roulette (OFF by default; the reference lists it as a
  TODO :187 and the north star requires it): after the first bounce a path
  survives with probability q = clamp(max(throughput), q_min, 1) and is
  reweighted by 1/q — unbiased.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp
import numpy as np

from ..ops.intersect import (
    Hit, intersect_scene, intersect_scene_uv, ray_planar_quad, ray_sphere,
)
from ..ops.sampling import (
    cosine_hemisphere, from_tangent, ggx_half_vector,
    henyey_greenstein_sample, orthonormal_basis, pdf_cosine,
    pdf_henyey_greenstein, pdf_quad, pdf_to_sphere, sample_to_quad,
    to_sphere, PI,
)
from ..ops.shade import (
    brdf_specular_scalar, effectively_smooth, find_refraction_direction,
    schlick_metal,
)
from ..ops.texture import bespoke_sample
from ..scene.schema import (
    MAX_BOUNCE_COUNT, MIN_HIT_DISTANCE, N_AIR, Scene,
)
from ..utils import prng
from ..utils.vec import (
    Vec3, dot, gather, hadamard, normalize, splat, where as vwhere,
)

# Debug render kinds (debug_render_kind_t, win32_main.cpp:22-28).
REGULAR = "regular"
PRIMARY_RAY_NORMALS = "primary_ray_normals"
BOUNCE_COUNT = "bounce_count"
TERMINATION_CONDITION = "termination_condition"
VARIANCE = "variance"  # handled by the accumulator; integrator == REGULAR
DEBUG_KINDS = (REGULAR, PRIMARY_RAY_NORMALS, BOUNCE_COUNT,
               TERMINATION_CONDITION, VARIANCE)


class TraceStats(NamedTuple):
    """Per-batch instrumentation for the Mrays/sec metric."""
    rays_cast: jnp.ndarray  # scalar: total intersect invocations over live lanes


class BounceOut(NamedTuple):
    """Result of shading one bounce at a batch of hits."""
    emit: Vec3            # material emission at the hit (add thr*emit)
    hitpoint: Vec3        # next ray origin
    L: Vec3               # next ray direction
    weight: Vec3          # throughput multiplier 2/px * brdfTerm
    cont: jnp.ndarray     # path continues (surface hit, valid estimator draw)
    hit_sky: jnp.ndarray
    hit_light: jnp.ndarray
    front_facing: jnp.ndarray  # NdotV > 0 (for the termination debug target)
    shading_normal: Vec3  # post-normal-map N (primary-ray-normals target)


# Material tables up to this many rows are looked up with an unrolled
# compare/select sweep; larger ones with one per-lane gather per field.
# Values are identical either way (pure lookup). On an H100 (400 W limit)
# the gather was faster at both sizes timed, 1280x720 and 16 spp: world 2
# (124 rows) 0.26 s vs 0.29 s, world 4 (485 rows) 0.18 s vs 0.33 s, and
# the sweep's code grows with the table (world 4: 83 s to compile vs 9 s).
# Every other world has at most 7 rows; the crossover below 124 rows is
# not measured.
_SELECT_LOOKUP_MAX = 32


def _material_fields(scene: Scene) -> dict:
    fields = dict(
        albedo=scene.mat_albedo, emit=scene.mat_emit,
        metal_color=scene.mat_metal_color,
        metalness=scene.mat_metalness, roughness=scene.mat_roughness,
        ior=scene.mat_ior,
        albedo_idx=scene.mat_albedo_idx,
        metalness_idx=scene.mat_metalness_idx,
        roughness_idx=scene.mat_roughness_idx,
        normal_idx=scene.mat_normal_idx,
    )
    if scene.any_transmissive:
        # only fetched when a dielectric exists: opaque scenes keep the
        # exact reference lookup set (and compiled code) unchanged
        fields["transmission"] = scene.mat_transmission
    if scene.any_dispersive:
        fields["dispersion"] = scene.mat_dispersion
    if scene.any_bump:
        fields["bump_idx"] = scene.mat_bump_idx
        fields["bump_scale"] = scene.mat_bump_scale
    return fields


def _const_field(v, mat):
    """Broadcast row 0 of a table-constant field (scene.mat_const): every
    real row holds the same value, so the lookup is the value itself —
    bit-identical to a sweep/gather, zero compare/select chains."""
    if isinstance(v, Vec3):
        return Vec3(jnp.full(mat.shape, v.x[0]),
                    jnp.full(mat.shape, v.y[0]),
                    jnp.full(mat.shape, v.z[0]))
    return jnp.full(mat.shape, v[0], v.dtype)


def _material_lookup(scene: Scene, mat: jnp.ndarray, sweep=None):
    """Per-lane material record lookup (material_t, ray.hpp:36-79).

    ``sweep`` picks the form: an unrolled compare/select sweep over the
    rows, or one per-lane gather per field. None = the sweep for tables of
    up to _SELECT_LOOKUP_MAX rows, gathers above."""
    n = scene.n_materials
    if sweep is None:
        sweep = n <= _SELECT_LOOKUP_MAX
    fields = _material_fields(scene)
    if not sweep:
        return {
            k: _const_field(v, mat) if k in scene.mat_const
            else gather(v, mat) if isinstance(v, Vec3) else v[mat]
            for k, v in fields.items()
        }
    out = {}
    for k, v in fields.items():
        if k in scene.mat_const:
            out[k] = _const_field(v, mat)
        elif isinstance(v, Vec3):
            accx = jnp.full(mat.shape, v.x[0])
            accy = jnp.full(mat.shape, v.y[0])
            accz = jnp.full(mat.shape, v.z[0])
            for i in range(1, n):
                take = mat == i
                accx = jnp.where(take, v.x[i], accx)
                accy = jnp.where(take, v.y[i], accy)
                accz = jnp.where(take, v.z[i], accz)
            out[k] = Vec3(accx, accy, accz)
        else:
            acc = jnp.full(mat.shape, v[0], v.dtype)
            for i in range(1, n):
                acc = jnp.where(mat == i, v[i], acc)
            out[k] = acc
    return out


def shade_bounce(
    scene: Scene,
    o: Vec3,
    d: Vec3,
    hit: Hit,
    u,  # tuple of BOUNCE_SLOTS (N,) uniforms
    just_importance: bool = False,
    mip_scale: float = 0.0,
    uv=None,  # (uvx, uvy, uv_ok) from intersect_scene_uv (mesh-UV scenes)
) -> BounceOut:
    """One bounce of RayCast's surface interaction (win32_main.cpp:576-792):
    material fetch, texture-driven parameters, estimator selection, BSDF
    weight. Pure function of (scene, ray, hit, uniforms) — shared verbatim
    by the unrolled and regeneration drivers."""
    just_cosine = scene.just_cosine
    shape = jnp.shape(o.x)
    ones_vec = splat((1.0, 1.0, 1.0), shape)

    mat = _material_lookup(scene, hit.mat)
    emit = mat["emit"]
    hit_sky = hit.mat == 0
    hit_light = (emit.x != 0.0) | (emit.y != 0.0) | (emit.z != 0.0)
    surface = ~hit_sky & ~hit_light

    # --- geometric terms (win32_main.cpp:592-651) -------------------------
    N_geom = hit.normal
    cos_theta_in = dot(N_geom, d)
    cos_theta_in = jnp.where(cos_theta_in > 0.0, -cos_theta_in, cos_theta_in)
    hitpoint = o + d * hit.t
    pure_bounce = d - N_geom * (2.0 * cos_theta_in)
    V = -d

    # texture-driven material parameters (win32_main.cpp:613-644)
    metalness = mat["metalness"]
    roughness = mat["roughness"]
    N = N_geom
    albedo_tex = None

    def _planar_fetch(idx, u=None, v=None):
        """Bespoke planar map fetch for 1-based material index field
        ``idx`` (0 = unbound; callers mask)."""
        layer = jnp.maximum(idx - 1, 0)
        uu = hitpoint.x if u is None else u
        vv = hitpoint.y if v is None else v
        return bespoke_sample(scene, layer, uu, vv)
    if scene.n_textures and scene.tex_combined:
        # canonical 4-map set: fused 2-word flat-gather fetch
        # (ops/texture.py)
        from ..ops import texture as _tex
        has_tex = mat["albedo_idx"] != 0
        lod = None
        if mip_scale and scene.tex_mip_meta:
            # Opt-in mip selection (RenderConfig.mip_scale; OFF by default —
            # mip-0-only is reference parity, win32_main.cpp:620,630,639).
            # Footprint: texels one pixel covers at distance t, widened by
            # grazing incidence; lod = floor(log2(fp)) via a static
            # threshold sweep, exact at the level boundaries. The oracle
            # computes the identical f32 expression (cpu_oracle._mip_lod).
            k = float(np.float32(mip_scale * scene.tex_comb_w * 0.5))
            fp = hit.t * jnp.float32(k) / jnp.maximum(
                jnp.abs(cos_theta_in), jnp.float32(0.1))
            lod = jnp.zeros(shape, jnp.int32)
            for lk in range(1, len(scene.tex_mip_meta)):
                lod = lod + (fp >= jnp.float32(2.0 ** lk)).astype(jnp.int32)
        if lod is not None:
            alb_c, met_c, rgh_c, nrm_c = _tex.bespoke_sample_combined_mip(
                scene, hitpoint.x, hitpoint.y, lod)
        else:
            alb_c, met_c, rgh_c, nrm_c = _tex.bespoke_sample_combined(
                scene, hitpoint.x, hitpoint.y)
        if scene.use_metalness_maps:
            metalness = jnp.where(mat["metalness_idx"] != 0, met_c, metalness)
        if scene.use_roughness_maps:
            roughness = jnp.where(mat["roughness_idx"] != 0, rgh_c, roughness)
        if scene.use_normal_maps:
            n_dec = Vec3(2.0 * nrm_c.x - 1.0, 2.0 * nrm_c.y - 1.0,
                         2.0 * nrm_c.z - 1.0)
            if scene.tbn_normal_maps:
                # rotate the decoded (z-up tangent space) normal into the
                # geometric frame — the reference's non-up-surface TODO
                # (win32_main.cpp:175); default replaces N in world space
                # exactly like :642
                bx, by, bz = orthonormal_basis(N_geom)
                n_dec = from_tangent(n_dec, bx, by, bz)
            n_mapped = normalize(n_dec, eps=1e-30)
            N = vwhere(mat["normal_idx"] != 0, n_mapped, N)
        albedo_tex = (has_tex, alb_c)
    elif scene.n_textures and not scene.tex_mesh_only:
        # (tex_mesh_only: every textured material is a triangle-albedo
        # binding, so these planar bespoke fetches can never apply, and
        # skipping them statically saves their gathers)
        if scene.use_metalness_maps:
            mtl_tex = _planar_fetch(mat["metalness_idx"])
            metalness = jnp.where(mat["metalness_idx"] != 0, mtl_tex.x, metalness)
        if scene.use_roughness_maps:
            rgh_tex = _planar_fetch(mat["roughness_idx"])
            roughness = jnp.where(mat["roughness_idx"] != 0, rgh_tex.x, roughness)
        if scene.use_normal_maps:
            n_tex = _planar_fetch(mat["normal_idx"])
            n_dec = Vec3(2.0 * n_tex.x - 1.0, 2.0 * n_tex.y - 1.0,
                         2.0 * n_tex.z - 1.0)
            if scene.tbn_normal_maps:
                # see the combined-set branch above
                bx, by, bz = orthonormal_basis(N_geom)
                n_dec = from_tangent(n_dec, bx, by, bz)
            n_mapped = normalize(n_dec, eps=1e-30)
            use_nm = mat["normal_idx"] != 0
            N = vwhere(use_nm, n_mapped, N)

    if scene.any_bump and scene.n_textures:
        # Height (bump) maps — the reference's unrealized "bump map" TODO
        # (win32_main.cpp:173). Forward-difference the height in the
        # bespoke planar frame (world-xy UVs, the same z-up convention as
        # the reference's normal maps :642) and tilt N against the
        # gradient: heightfield normal ∝ (-dh/dx, -dh/dy, 1).
        beps = jnp.float32(0.01)
        h0 = _planar_fetch(mat["bump_idx"]).x
        hx = _planar_fetch(mat["bump_idx"], hitpoint.x + beps, hitpoint.y).x
        hy = _planar_fetch(mat["bump_idx"], hitpoint.x, hitpoint.y + beps).x
        bs = mat["bump_scale"]
        gx = (hx - h0) / beps * bs
        gy = (hy - h0) / beps * bs
        nb = normalize(Vec3(N.x - gx, N.y - gy, N.z), eps=1e-30)
        N = vwhere(mat["bump_idx"] != 0, nb, N)

    ndotv = dot(N, V)
    front_facing = ndotv > 0.0

    # --- estimator (win32_main.cpp:660-792) --------------------------------
    b_specular = u[0] > 0.5
    b_sample_cosine = u[1] > 0.5

    smooth = effectively_smooth(roughness)
    tx, ty, tz = orthonormal_basis(N)

    # case B: rough specular — GGX half vector in the N-frame (:724-731)
    h_t = ggx_half_vector(u[2], u[3], roughness)
    H_spec = normalize(from_tangent(h_t, tx, ty, tz), eps=1e-30)
    L_spec = H_spec * (2.0 * dot(V, H_spec)) - V

    # case C: diffuse — cosine or to-sphere sample (:676-722)
    light_center = Vec3(scene.sph_center.x[0], scene.sph_center.y[0],
                        scene.sph_center.z[0])
    light_radius = scene.sph_radius[0]
    cos_dir = cosine_hemisphere(u[2], u[3])
    light_dir = light_center - hitpoint
    sph_dir, ts_valid = to_sphere(u[2], u[3], light_center, light_radius, hitpoint)
    lx, ly, lz = orthonormal_basis(light_dir)
    if just_importance:
        use_cosine = jnp.zeros(shape, bool)
    elif just_cosine:
        use_cosine = jnp.ones(shape, bool)
    else:
        use_cosine = b_sample_cosine
    if scene.quad_light >= 0:
        # Quad-light NEE (our world 6): the importance half of the mixture
        # samples a uniform point on the light quad and weights by the
        # reference's PdfValueQuad (win32_main.cpp:301-322 — defined there,
        # never called; its intersection runs at MIN_HIT_DISTANCE, NOT the
        # dispatcher's 0.02 quad quirk, :448-451). The cosine half keeps the
        # raw-frame quirk for cosine-sampled lanes; quad-sampled lanes have
        # no tangent-space raw sample, so their cosine term is the true
        # shading-frame pdf max(0, N.L)/pi.
        qi = scene.quad_light
        qp = Vec3(scene.quad_point.x[qi], scene.quad_point.y[qi],
                  scene.quad_point.z[qi])
        ql_u = Vec3(scene.quad_u.x[qi], scene.quad_u.y[qi], scene.quad_u.z[qi])
        ql_v = Vec3(scene.quad_v.x[qi], scene.quad_v.y[qi], scene.quad_v.z[qi])
        L_quad = normalize(
            sample_to_quad(u[2], u[3], qp, ql_u, ql_v, hitpoint), eps=1e-30)
        cos_world = normalize(from_tangent(cos_dir, tx, ty, tz), eps=1e-30)
        L_diff = vwhere(use_cosine, cos_world, L_quad)
        pcos = jnp.where(use_cosine, pdf_cosine(cos_dir),
                         jnp.maximum(0.0, dot(N, L_diff)) / PI)
        tq, q_hit = ray_planar_quad(hitpoint, L_diff, qp, ql_u, ql_v,
                                    min_hit=MIN_HIT_DISTANCE)
        pimp = pdf_quad(tq, q_hit, L_diff, ql_u, ql_v)
        imp_valid = jnp.ones(shape, bool)
    else:
        r_dir = vwhere(use_cosine, cos_dir, sph_dir)
        fx, fy, fz = (
            vwhere(use_cosine, tx, lx),
            vwhere(use_cosine, ty, ly),
            vwhere(use_cosine, tz, lz),
        )
        L_diff = normalize(from_tangent(r_dir, fx, fy, fz), eps=1e-30)
        # mixture pdf: cosine pdf of the raw sample in its own frame (the
        # reference quirk) + solid-angle pdf of the world-space direction
        pcos = pdf_cosine(r_dir)
        _, sph_hit, _ = ray_sphere(hitpoint, L_diff, light_center,
                                   light_radius, MIN_HIT_DISTANCE)
        pimp = pdf_to_sphere(sph_hit, light_center, light_radius, hitpoint)
        imp_valid = ts_valid
    if just_cosine:
        px_diff = pcos
    elif just_importance:
        px_diff = pimp
    else:
        px_diff = 0.5 * pcos + 0.5 * pimp
    diff_valid = (px_diff > 0.0) & (use_cosine | imp_valid)

    # select estimator results per lane
    case_a = b_specular & smooth
    case_b = b_specular & ~smooth
    L = vwhere(case_a, pure_bounce, vwhere(case_b, L_spec, L_diff))
    H = vwhere(case_b, H_spec, normalize(L_diff + V, eps=1e-30))
    px = jnp.where(b_specular, 1.0, px_diff)
    est_valid = b_specular | diff_valid

    ndotl = dot(N, L)
    in_hemisphere = ndotl > 0.0

    # Fresnel (win32_main.cpp:738-749)
    ior = mat["ior"]
    F0 = ((N_AIR - ior) / (N_AIR + ior)) ** 2
    hdotl = dot(H, L)
    hdotv = dot(H, V)
    ks_cos = jnp.where(smooth, ndotl, hdotl)
    ks = schlick_metal(F0, ks_cos, metalness, mat["metal_color"])
    hv_ok = smooth | ((hdotv > 0.0) & (hdotl > 0.0))

    # kd with metal kill (win32_main.cpp:751-759)
    kd = Vec3(
        (ones_vec.x - ks.x) * (1.0 - metalness),
        (ones_vec.y - ks.y) * (1.0 - metalness),
        (ones_vec.z - ks.z) * (1.0 - metalness),
    )

    # brdfTerm (win32_main.cpp:761-773)
    albedo = mat["albedo"]
    if albedo_tex is not None:
        albedo = vwhere(albedo_tex[0], albedo_tex[1], albedo)
    elif scene.n_textures and not scene.tex_mesh_only:
        alb_tex = _planar_fetch(mat["albedo_idx"])
        albedo = vwhere(mat["albedo_idx"] != 0, alb_tex, albedo)
    if uv is not None:
        # Mesh-UV textured materials (gltf.load_gltf_textured — the
        # reference's "load materials with textures" TODO,
        # win32_main.cpp:172): lanes whose winner is a UV triangle sample
        # the material's texture at the interpolated texcoord, MODULATED
        # by the material albedo (= glTF baseColorFactor, spec semantics)
        # — unlike the bespoke path, which replaces.
        from ..ops import texture as _tex
        uvx, uvy, uv_ok = uv
        layer = jnp.maximum(mat["albedo_idx"] - 1, 0)
        use_uv = uv_ok & (mat["albedo_idx"] != 0)
        tex_uv = _tex.sample_texture(scene, layer, uvx, uvy)
        albedo = vwhere(use_uv, hadamard(mat["albedo"], tex_uv), albedo)
    brdf_diff = hadamard(kd, albedo) * (ndotl / PI)
    spec_scalar = brdf_specular_scalar(N, L, V, H, roughness)
    brdf_spec = ks * spec_scalar
    brdf = vwhere(case_a, ks, vwhere(case_b, brdf_spec, brdf_diff))

    inv_px = jnp.where(px > 0.0, 1.0 / jnp.where(px > 0.0, px, 1.0), 0.0)
    weight = brdf * (2.0 * inv_px)

    cont = surface & front_facing & in_hemisphere & hv_ok & est_valid

    if scene.any_transmissive:
        # Delta dielectric lobe — finishing the reference's in-progress
        # refraction (FindRefractionDirection win32_main.cpp:1622-1661; the
        # F0 "when support refraction again" comment :600-601). Estimator:
        # pick reflect with probability F (Schlick from the material ior),
        # else refract (TIR falls back to reflect); each branch's
        # throughput weight is albedo (the F/F and (1-F)/(1-F) terms
        # cancel), no x2 correction (single estimator). Transmissive lanes
        # bypass the front-facing/hemisphere gates: refraction crosses the
        # surface, and exit hits arrive back-facing by construction.
        trans = mat["transmission"] > 0.0
        cos_i = -cos_theta_in  # |cos| of the arriving angle (:596-598)
        ior_t, F0_t = ior, F0
        if scene.any_dispersive:
            # Spectral dispersion — the reference's "different wavelengths
            # refract differently" TODO (win32_main.cpp:169-170). One
            # channel per path (coin u[6] — a FRESH slot: u[5] conditioned
            # on reaching the surface is non-uniform under fog), refracted
            # with ior + dispersion*(c-1); throughput masks to that channel
            # x3, an unbiased spectral estimator (E[3*mask_c] = 1).
            disp = mat["dispersion"]
            ch = jnp.minimum((u[6] * 3.0).astype(jnp.int32), 2)
            is_disp = disp > 0.0
            ior_t = jnp.where(is_disp,
                              ior + disp * (ch.astype(jnp.float32) - 1.0),
                              ior)
            F0_t = jnp.where(is_disp,
                             ((N_AIR - ior_t) / (N_AIR + ior_t)) ** 2, F0)
        # Approximation kept from the reference's Schlick setup: F0 uses the
        # air-side ior and cos_i is the incident-side angle even when exiting
        # the denser medium (the exact curve would rise to 1 at the critical
        # angle). TIR itself is handled exactly by the refract branch below.
        fres = F0_t + (1.0 - F0_t) * (1.0 - jnp.clip(cos_i, 0.0, 1.0)) ** 5
        refr_dir, refracted = find_refraction_direction(d, N_geom, ior_t)
        # True sign-safe mirror. pure_bounce (above) folds in the sign-flipped
        # cos_theta_in and is only a mirror for FRONT faces (fine for the
        # opaque estimators, which gate on front_facing); interior glass hits
        # arrive back-facing, where d - 2(N.d)N is the correct reflection —
        # pure_bounce there would send TIR OUT through the surface.
        mirror = d - N_geom * (2.0 * dot(N_geom, d))
        take_reflect = (u[0] < fres) | ~refracted
        L_t = vwhere(take_reflect, mirror, refr_dir)
        L = vwhere(trans, L_t, L)
        w_trans = albedo
        if scene.any_dispersive:
            three = jnp.float32(3.0)
            mask = Vec3((ch == 0).astype(jnp.float32) * three,
                        (ch == 1).astype(jnp.float32) * three,
                        (ch == 2).astype(jnp.float32) * three)
            w_trans = vwhere(is_disp, hadamard(albedo, mask), albedo)
        weight = vwhere(trans, w_trans, weight)
        cont = (trans & surface) | (~trans & cont)

    if scene.fog_sigma_t > 0.0:
        # Global homogeneous fog — the reference's unrealized '"god rays"
        # and fog, both via volumetric light transport' TODO
        # (win32_main.cpp:159). Distance sampling: free flight
        # s = -ln(1-u)/sigma_t; a path scatters IN the medium when s
        # undercuts the surface hit (sky rays, t = F32_MAX, always
        # scatter — fog occludes the sky). The exponential transmittance
        # cancels exactly against the flight pdf, so pass-through lanes
        # carry weight 1 and scatter lanes weight albedo * phase/px —
        # unbiased single-estimator volume transport, no x2 correction.
        # Volume and surface events are disjoint per lane, so the surface
        # estimator's slots reuse freely: u[1] mixture coin, u[2]/u[3]
        # direction; only the flight distance needs the fresh slot u[5].
        g = scene.fog_g
        s = -jnp.log(jnp.maximum(1.0 - u[5], 1e-30)) \
            / jnp.float32(scene.fog_sigma_t)
        vol = s < hit.t
        vp = o + d * s
        # 50/50 phase-sample / light-sample NEE mixture, both pdfs
        # evaluated at the chosen direction (the quad-light style; the
        # raw-frame PdfCos quirk is a surface-estimator replication, not
        # repeated here).
        use_phase = u[1] > 0.5
        fwx, fwy, fwz = orthonormal_basis(d)
        ph_t = henyey_greenstein_sample(u[2], u[3], g)
        L_phase = normalize(from_tangent(ph_t, fwx, fwy, fwz), eps=1e-30)
        if scene.quad_light >= 0:
            qi = scene.quad_light
            qp = Vec3(scene.quad_point.x[qi], scene.quad_point.y[qi],
                      scene.quad_point.z[qi])
            ql_u = Vec3(scene.quad_u.x[qi], scene.quad_u.y[qi],
                        scene.quad_u.z[qi])
            ql_v = Vec3(scene.quad_v.x[qi], scene.quad_v.y[qi],
                        scene.quad_v.z[qi])
            L_light = normalize(
                sample_to_quad(u[2], u[3], qp, ql_u, ql_v, vp), eps=1e-30)
            L_vol = vwhere(use_phase, L_phase, L_light)
            tq_v, qh_v = ray_planar_quad(vp, L_vol, qp, ql_u, ql_v,
                                         min_hit=MIN_HIT_DISTANCE)
            p_light = pdf_quad(tq_v, qh_v, L_vol, ql_u, ql_v)
            imp_ok = jnp.ones(shape, bool)
        else:
            l_dir = light_center - vp
            sph_t, ts_ok = to_sphere(u[2], u[3], light_center, light_radius,
                                     vp)
            gx, gy, gz = orthonormal_basis(l_dir)
            L_light = normalize(from_tangent(sph_t, gx, gy, gz), eps=1e-30)
            L_vol = vwhere(use_phase, L_phase, L_light)
            _, sph_ok, _ = ray_sphere(vp, L_vol, light_center, light_radius,
                                      MIN_HIT_DISTANCE)
            p_light = pdf_to_sphere(sph_ok, light_center, light_radius, vp)
            imp_ok = ts_ok
        f_p = pdf_henyey_greenstein(dot(d, L_vol), g)
        px_v = 0.5 * f_p + 0.5 * p_light
        vol_ok = (px_v > 0.0) & (use_phase | imp_ok)
        w_s = f_p * jnp.where(px_v > 0.0,
                              1.0 / jnp.where(px_v > 0.0, px_v, 1.0), 0.0)
        fa = scene.fog_albedo
        w_vol = Vec3(w_s * jnp.float32(fa[0]), w_s * jnp.float32(fa[1]),
                     w_s * jnp.float32(fa[2]))
        zero3 = Vec3(jnp.zeros(shape), jnp.zeros(shape), jnp.zeros(shape))
        emit = vwhere(vol, zero3, emit)
        hitpoint = vwhere(vol, vp, hitpoint)
        L = vwhere(vol, L_vol, L)
        weight = vwhere(vol, w_vol, weight)
        cont = (vol & vol_ok) | (~vol & cont)
        hit_sky = hit_sky & ~vol
        hit_light = hit_light & ~vol
        front_facing = front_facing | vol  # a scatter is not a back-face

    return BounceOut(
        emit=emit, hitpoint=hitpoint, L=L, weight=weight, cont=cont,
        hit_sky=hit_sky, hit_light=hit_light, front_facing=front_facing,
        shading_normal=vwhere(surface, N, N_geom),
    )


def russian_roulette(throughput: Vec3, u_rr: jnp.ndarray, q_min: float = 0.05):
    """Unbiased RR: survive with q = clamp(max channel of throughput,
    q_min, 1), reweight by 1/q. The reference lists RR as unrealized future
    work (win32_main.cpp:187); BASELINE.json's north star requires it."""
    lum = jnp.maximum(jnp.maximum(throughput.x, throughput.y), throughput.z)
    q = jnp.clip(lum, q_min, 1.0)
    survive = u_rr < q
    inv_q = 1.0 / q
    return survive, Vec3(throughput.x * inv_q, throughput.y * inv_q,
                         throughput.z * inv_q)


def trace(
    scene: Scene,
    o: Vec3,
    d: Vec3,
    pkeys: prng.PathStream,
    debug_kind: str = REGULAR,
    just_importance: bool = False,
    use_russian_roulette: bool = False,
    mip_scale: float = 0.0,
) -> Tuple[Vec3, TraceStats]:
    """Trace a batch of primary rays to radiance (RayCast, win32_main.cpp:558-823),
    unrolled over MAX_BOUNCE_COUNT. ``pkeys`` are per-path PCG4D streams
    (utils/prng.py); all randomness is a pure function of them, so results
    are independent of batch shape and sharding."""
    assert debug_kind in DEBUG_KINDS
    assert not (scene.just_cosine and just_importance), "they can't both be true"

    shape = jnp.shape(o.x)
    zeros = lambda: jnp.zeros(shape)
    zvec = lambda: Vec3(zeros(), zeros(), zeros())

    radiance = zvec()
    throughput = splat((1.0, 1.0, 1.0), shape)
    alive = jnp.ones(shape, bool)
    rays_cast = jnp.zeros((), jnp.float32)

    # debug-mode carries
    primary_n = zvec()
    cond_color = zvec()
    cond_done = jnp.zeros(shape, bool)

    accumulate_regular = debug_kind in (REGULAR, VARIANCE)

    for b in range(MAX_BOUNCE_COUNT):
        rays_cast = rays_cast + jnp.sum(alive.astype(jnp.float32))
        if scene.has_mesh_uvs:
            hit, uvx, uvy, uv_ok = intersect_scene_uv(scene, o, d)
            uv = (uvx, uvy, uv_ok)
        else:
            hit, uv = intersect_scene(scene, o, d), None
        is_terminal_depth = b == MAX_BOUNCE_COUNT - 1

        u = prng.bounce_uniforms_v(pkeys, b)
        out = shade_bounce(scene, o, d, hit, u, just_importance=just_importance,
                           mip_scale=mip_scale, uv=uv)

        if accumulate_regular:
            # radiance += emitColor at every level (win32_main.cpp:799),
            # scaled by the path throughput.
            contrib = hadamard(throughput, out.emit)
            radiance = Vec3(
                jnp.where(alive, radiance.x + contrib.x, radiance.x),
                jnp.where(alive, radiance.y + contrib.y, radiance.y),
                jnp.where(alive, radiance.z + contrib.z, radiance.z),
            )
        if debug_kind == BOUNCE_COUNT:
            # += 1/MAX_BOUNCE_COUNT per level reached (win32_main.cpp:801-804)
            c = 1.0 / MAX_BOUNCE_COUNT
            radiance = Vec3(
                jnp.where(alive, radiance.x + c, radiance.x),
                jnp.where(alive, radiance.y + c, radiance.y),
                jnp.where(alive, radiance.z + c, radiance.z),
            )

        if b == 0:
            # primary-ray normals debug: N after optional normal mapping for
            # surfaces, geometric N (0 for sky) otherwise (win32_main.cpp:806-807)
            primary_n = out.shading_normal

        if debug_kind == TERMINATION_CONDITION:
            # color-coded first termination cause (win32_main.cpp:809-820)
            def set_cond(mask, rgb, color, done):
                take = mask & alive & ~done
                return vwhere(take, splat(rgb, shape), color), done | take
            cond_color, cond_done = set_cond(out.hit_sky, (0, 0, 1), cond_color, cond_done)
            cond_color, cond_done = set_cond(out.hit_light, (0, 1, 0), cond_color, cond_done)
            cond_color, cond_done = set_cond(
                jnp.full(shape, is_terminal_depth), (1, 0, 0), cond_color, cond_done)
            cond_color, cond_done = set_cond(~out.front_facing, (1, 1, 0), cond_color, cond_done)

        if is_terminal_depth:
            alive = jnp.zeros(shape, bool)
            break

        cont = alive & out.cont
        if accumulate_regular:
            new_thr = hadamard(throughput, out.weight)
            if use_russian_roulette and b >= 1:
                survive, rr_thr = russian_roulette(new_thr, u[4])
                cont = cont & survive
                new_thr = rr_thr
            throughput = vwhere(cont, new_thr, throughput)
        o = vwhere(cont, out.hitpoint, o)
        d = vwhere(cont, out.L, d)
        alive = cont

    if debug_kind == PRIMARY_RAY_NORMALS:
        radiance = primary_n * 0.5 + splat((0.5, 0.5, 0.5), shape)
    elif debug_kind == TERMINATION_CONDITION:
        radiance = cond_color

    return radiance, TraceStats(rays_cast=rays_cast)

