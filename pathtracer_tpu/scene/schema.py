"""Device-resident scene representation (flat SoA tables).

The reference stores the world as stretchy buffers of structs wired into a
global ``world_t`` (reference include/ray.hpp:36-162, win32_main.cpp:97-108,
2039-2045). Here a scene is compiled once on the host into padded,
static-shape structure-of-arrays tables that live in device memory; the
integrator scans them with masked lanes instead of pointer-chasing.

Conventions preserved from the reference:
- material 0 is the sky (AddSky pushes it first, win32_main.cpp:2048-2051);
  a ray miss reports hitMatIndex 0 (win32_main.cpp:411-412);
- spheres[0] is the hardcoded important light for NEE
  (win32_main.cpp:683);
- material scalar defaults: alpha=1, ior=1, metalness=0, roughness=1,
  albedo=(0,0,0), emit=(0,0,0), texture indices 0 = "no texture"
  (include/ray.hpp:63-78 default member initializers);
- the ``aabbs`` table exists but is never populated by LoadWorld
  (win32_main.cpp:2039-2045) — kept for parity, always empty.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import jax.numpy as jnp
from ..utils import struct
from ..utils.vec import Vec3, cross as _vec_cross, normalize as _vec_normalize


def _bake_quad_normals(u: Vec3, v: Vec3) -> Vec3:
    """normalize(cross(u, v)) over the quad table — the exact expression
    intersect_quads evaluated per bounce (win32_main.cpp:437-456 face
    normal), baked once at finalize. Elementwise over the table, so each
    quad's value is bit-identical to the old per-quad scalar compute."""
    return _vec_normalize(_vec_cross(u, v), eps=1e-30)

# Reference constants (win32_main.cpp:86-95).
MAX_BOUNCE_COUNT = 4
MIN_HIT_DISTANCE = 1e-4
QUAD_MIN_HIT_DISTANCE = 0.02  # Cornell-box hack, win32_main.cpp:446
TOLERANCE = 1e-9
WORLD_SIZE = 5.0
LEVELS = 6
N_AIR = 1.003
LIGHT_KIND_DIRECTIONAL = 0
LIGHT_KIND_POINT = 1
LIGHT_KIND_TRIANGLE = 2
FIXED_FOCAL_LENGTH = 0.098
MIN_ROUGHNESS = 0.01
F32_MAX = float(np.finfo(np.float32).max)

WORLD_DEFAULT = 0
WORLD_BRDF_TEST = 1
WORLD_CORNELL_BOX = 2
WORLD_RAYTRACING_ONE_WEEKEND = 3
WORLD_MARIO = 4
# Beyond the reference's five: Cornell box lit by an emissive QUAD, the
# scene the reference's dead PdfValueQuad (win32_main.cpp:301-322) was
# written for. Exercises the quad-light NEE mixture (Scene.quad_light).
WORLD_CORNELL_QUAD = 5
# Our seventh world (-w7): a procedurally UV-mapped sphere mesh with a
# generated pow2 texture — the mesh-UV textured-materials path (the
# reference's "load materials with textures" TODO realized) end to end,
# asset-free and deterministic.
WORLD_MESH_UV = 6
WORLD_KIND_COUNT = 7


def _pad(n: int, multiple: int = 16) -> int:
    """Pad table sizes to a multiple of the chunk width of
    ops/intersect._scan_table_chunked (16)."""
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


@struct.dataclass
class Scene:
    """All scene data as padded SoA device arrays. A JAX pytree: passing it
    through jit/shard_map/scan is free of host sync."""

    # --- materials (index 0 = sky) --------------------------------------
    mat_albedo: Vec3        # (M,) per component
    mat_emit: Vec3
    mat_metal_color: Vec3
    mat_metalness: jnp.ndarray
    mat_roughness: jnp.ndarray
    mat_ior: jnp.ndarray
    # Dielectric transmission fraction (see HostMaterial.transmission).
    mat_transmission: jnp.ndarray
    # Spectral dispersion half-spread (see HostMaterial.dispersion).
    mat_dispersion: jnp.ndarray
    # material_t.alpha (ray.hpp:63, default 1): defined by the reference but
    # never read by its render path; stored for struct parity.
    mat_alpha: jnp.ndarray
    mat_albedo_idx: jnp.ndarray     # int32, 0 = none else 1-based texture id
    mat_bump_idx: jnp.ndarray       # int32, 0 = none (see HostMaterial.bump_idx)
    mat_bump_scale: jnp.ndarray
    mat_metalness_idx: jnp.ndarray
    mat_roughness_idx: jnp.ndarray
    mat_normal_idx: jnp.ndarray

    # --- spheres (index 0 = NEE important light) -------------------------
    sph_center: Vec3
    sph_radius: jnp.ndarray
    sph_mat: jnp.ndarray
    sph_mask: jnp.ndarray   # bool: valid (non-padding) entries

    # --- quads ------------------------------------------------------------
    quad_point: Vec3
    quad_u: Vec3
    quad_v: Vec3
    quad_mat: jnp.ndarray
    quad_mask: jnp.ndarray

    # --- planes -----------------------------------------------------------
    pln_n: Vec3
    pln_d: jnp.ndarray
    pln_mat: jnp.ndarray
    pln_mask: jnp.ndarray

    # --- triangles (flat; traversed via the accel grid when present) ------
    tri_a: Vec3             # vertex A
    tri_u: Vec3             # B - A
    tri_v: Vec3             # C - A
    tri_mat: jnp.ndarray
    # Per-triangle texture coordinates (mesh-UV scenes, has_mesh_uvs):
    # uv of vertex A plus the edge deltas to B and C, so the winner's uv
    # interpolates directly from the hit barycentrics
    # (ops/intersect.intersect_scene_uv). (1,) dummies otherwise.
    tri_uv0u: jnp.ndarray
    tri_uv0v: jnp.ndarray
    tri_uvdu1: jnp.ndarray
    tri_uvdv1: jnp.ndarray
    tri_uvdu2: jnp.ndarray
    tri_uvdv2: jnp.ndarray
    tri_mask: jnp.ndarray

    # --- axis-aligned boxes (parity with world_t.aabbs; always empty) -----
    box_min: Vec3
    box_max: Vec3
    box_mat: jnp.ndarray
    box_mask: jnp.ndarray

    # --- explicit lights (light_t, ray.hpp:122-135) ------------------------
    # The reference defines directional/point/triangle lights but its only
    # use is commented out (AddSunDirectionalLight, win32_main.cpp:2053-2056);
    # lights are emissive GEOMETRY instead. Table kept for API parity; the
    # integrator, like RayCast, never reads it.
    light_kind: jnp.ndarray   # int32: 0 directional, 1 point, 2 triangle
    light_vec: Vec3           # direction (directional) or position (point)
    light_radiance: Vec3
    light_mask: jnp.ndarray

    # --- acceleration structure (uniform grid over triangles) -------------
    # CSR layout: cell c owns grid_tris[grid_cell_start[c] : +grid_cell_count[c]].
    grid_cell_start: jnp.ndarray   # (ncells,) int32
    grid_cell_count: jnp.ndarray   # (ncells,) int32
    grid_tris: jnp.ndarray         # (total_refs,) int32 triangle indices

    # --- textures (mip level 0 only; the reference samples mips[0]
    #     everywhere, win32_main.cpp:619-640,1601-1605). Texels are packed
    #     RGB8 in a flat int32 array: ONE gather per texel fetch instead of
    #     three float gathers (gathers dominate textured-scene cost).
    tex_packed: jnp.ndarray        # (K*Hmax*Wmax,) int32, r | g<<8 | b<<16
    tex_w: jnp.ndarray             # (K,) int32 actual widths
    tex_h: jnp.ndarray             # (K,) int32 actual heights
    # Combined fast path for the reference's canonical 4-map material set
    # (albedoIdx=1, metalnessIdx=2, roughnessIdx=3, normalIdx=4, all equal
    # size — LoadBespokeTextures, win32_main.cpp:1711-1724): two words per
    # texel halve the per-bounce gather count (8 instead of 16).
    tex_comb_a: jnp.ndarray        # (H*W,) int32: albedo.rgb | metalness.r<<24
    tex_comb_b: jnp.ndarray        # (H*W,) int32: normal.rgb | roughness.r<<24
    tex_hmax: int = struct.field(pytree_node=False, default=1)
    tex_wmax: int = struct.field(pytree_node=False, default=1)
    tex_combined: bool = struct.field(pytree_node=False, default=False)
    tex_comb_w: int = struct.field(pytree_node=False, default=1)
    tex_comb_h: int = struct.field(pytree_node=False, default=1)
    # Combined-set mip pyramid (built for square pow2 sets): per-level
    # (word_offset, w, h) statics indexing tex_comb_* — level 0 leads, so
    # mip-0-only consumers (the reference-parity default) never notice.
    # () = no pyramid. Opt-in sampling via RenderConfig.mip_scale (the
    # reference's unfinished "mipmapping" TODO, GenerateMipmapChain
    # win32_main.cpp:2307-2328).
    tex_mip_meta: tuple = struct.field(pytree_node=False, default=())
    # every textured material uses ONLY albedo_idx and is referenced only
    # by triangles: shade_bounce then skips the bespoke planar fetches
    # entirely (semantics-neutral — such lanes are always mesh-UV winners)
    tex_mesh_only: bool = struct.field(pytree_node=False, default=False)

    # normalize(cross(u, v)) per quad, baked at finalize with the SAME jnp
    # expression intersect_quads used to evaluate per bounce (bit-identical
    # values). None only in hand-built test Scenes predating the field.
    quad_n: Optional[Vec3] = None

    # --- static (compile-time) metadata -----------------------------------
    world_kind: int = struct.field(pytree_node=False, default=WORLD_DEFAULT)
    # World 4 forces cosine-only sampling (win32_main.cpp:654-655).
    just_cosine: bool = struct.field(pytree_node=False, default=False)
    # True iff any material has transmission > 0; static so opaque scenes
    # compile exactly the reference estimator with no dielectric code.
    any_transmissive: bool = struct.field(pytree_node=False, default=False)
    # True iff any transmissive material disperses; static so plain-glass
    # scenes compile the single-ior lobe unchanged.
    any_dispersive: bool = struct.field(pytree_node=False, default=False)
    # True iff any material carries a bump (height) map; static so
    # bump-free scenes compile the exact reference texture pipeline.
    any_bump: bool = struct.field(pytree_node=False, default=False)
    # True iff the mesh carries per-vertex texture coordinates
    # (WorldBuilder.set_mesh uvs / gltf.load_gltf_textured): the XLA
    # drivers then route intersection through intersect_scene_uv and the
    # winner's uv modulates the material albedo by its texture. Static so
    # uv-less scenes compile exactly the reference pipeline.
    has_mesh_uvs: bool = struct.field(pytree_node=False, default=False)
    # Index of the quad the NEE mixture targets, or -1 for the reference
    # default (spheres[0], win32_main.cpp:683). Static so sphere-light
    # scenes compile exactly the reference estimator; >= 0 swaps the
    # to-sphere term for the PdfValueQuad semantics (:301-322) the
    # reference defined but never wired up.
    quad_light: int = struct.field(pytree_node=False, default=-1)
    # Global homogeneous fog (WorldBuilder.set_fog — the reference's
    # unrealized "god rays and fog via volumetric light transport" TODO,
    # win32_main.cpp:159). Static so fog-free scenes compile exactly the
    # reference estimator with zero volume code. sigma_t = extinction,
    # fog_albedo = sigma_s/sigma_t per channel, fog_g = HG anisotropy.
    fog_sigma_t: float = struct.field(pytree_node=False, default=0.0)
    fog_albedo: tuple = struct.field(pytree_node=False,
                                     default=(1.0, 1.0, 1.0))
    fog_g: float = struct.field(pytree_node=False, default=0.0)
    n_spheres: int = struct.field(pytree_node=False, default=0)
    n_quads: int = struct.field(pytree_node=False, default=0)
    n_planes: int = struct.field(pytree_node=False, default=0)
    n_tris: int = struct.field(pytree_node=False, default=0)
    n_boxes: int = struct.field(pytree_node=False, default=0)
    n_materials: int = struct.field(pytree_node=False, default=0)
    # material fields whose column is ONE value across the real rows —
    # the lookup broadcasts row 0 instead of sweeping (bit-identical;
    # round-5 op-count pass, integrator._material_lookup)
    mat_const: tuple = struct.field(pytree_node=False, default=())
    n_textures: int = struct.field(pytree_node=False, default=0)
    grid_res: int = struct.field(pytree_node=False, default=0)
    # Opt-in tangent-frame normal mapping (the reference's "support normal
    # maps applied to surface where the normal is not pointing directly
    # up" TODO, win32_main.cpp:175): decoded map normals rotate into the
    # geometric surface frame instead of replacing N in world space (the
    # reference behavior, :642, kept as the parity default).
    tbn_normal_maps: bool = struct.field(pytree_node=False, default=False)
    # texture enablement flags (-n -m -r CLI flags, win32_main.cpp:2173-2178)
    use_normal_maps: bool = struct.field(pytree_node=False, default=True)
    use_metalness_maps: bool = struct.field(pytree_node=False, default=True)
    use_roughness_maps: bool = struct.field(pytree_node=False, default=True)

    @property
    def has_light_sphere(self) -> bool:
        return self.n_spheres > 0


@dataclasses.dataclass
class HostMaterial:
    """Host-side material mirroring material_t defaults (ray.hpp:63-78)."""
    alpha: float = 1.0
    albedo: tuple = (0.0, 0.0, 0.0)
    emit: tuple = (0.0, 0.0, 0.0)
    metal_color: tuple = (0.0, 0.0, 0.0)
    metalness: float = 0.0
    roughness: float = 1.0
    ior: float = 1.0
    # Dielectric transmission (glass): 0 = opaque (exact reference
    # behavior); > 0 enables the delta reflect/refract lobe the reference
    # left unfinished (win32_main.cpp:169,1622-1661, F0 comment :600-601).
    transmission: float = 0.0
    # Spectral dispersion half-spread for transmissive dielectrics (the
    # reference's "different wavelengths refract differently" TODO,
    # :169-170): per-path channel c in {R,G,B} refracts with
    # ior + dispersion * (c - 1), i.e. red bends least, blue most.
    dispersion: float = 0.0
    albedo_idx: int = 0
    metalness_idx: int = 0
    roughness_idx: int = 0
    normal_idx: int = 0
    # Height (bump) map — the reference's unrealized "bump map" TODO
    # (win32_main.cpp:173): the geometric normal tilts against the
    # height's finite-difference gradient in the bespoke planar frame.
    bump_idx: int = 0
    bump_scale: float = 1.0


class WorldBuilder:
    """Host-side scene assembly (the nc_sbpush role, include/nc_ds.h:12-35)."""

    def __init__(self):
        self.materials: list[HostMaterial] = []
        self.lights: list[tuple] = []       # (kind, vec, radiance)
        self.spheres: list[tuple] = []      # (center, radius, mat)
        self.quads: list[tuple] = []        # (point, u, v, mat)
        self.planes: list[tuple] = []       # (n, d, mat)
        self.triangles: Optional[np.ndarray] = None  # (T, 3, 3) float32
        self.tri_mats: Optional[np.ndarray] = None   # (T,) int32
        self.tri_uvs: Optional[np.ndarray] = None    # (T, 3, 2) float32
        self.textures: list[np.ndarray] = []         # (H, W, 3) float32 each
        self.quad_light: int = -1                    # see set_quad_light
        self.fog: tuple = (0.0, (1.0, 1.0, 1.0), 0.0)  # see set_fog
        self.tbn_normal_maps: bool = False  # see Scene.tbn_normal_maps

    def add_material(self, **kw) -> int:
        self.materials.append(HostMaterial(**kw))
        return len(self.materials) - 1

    def add_light(self, kind, vec, radiance) -> int:
        """light_t push (parity; the reference never renders these)."""
        self.lights.append((int(kind), tuple(vec), tuple(radiance)))
        return len(self.lights) - 1

    def add_sphere(self, center, radius, mat) -> int:
        self.spheres.append((tuple(center), float(radius), int(mat)))
        return len(self.spheres) - 1

    def add_quad(self, point, u, v, mat) -> int:
        self.quads.append((tuple(point), tuple(u), tuple(v), int(mat)))
        return len(self.quads) - 1

    def set_quad_light(self, idx: int):
        """Mark quad ``idx`` as the NEE target (PdfValueQuad semantics,
        win32_main.cpp:301-322). Default -1 keeps spheres[0] (:683)."""
        if not (0 <= idx < len(self.quads)):
            raise ValueError(f"quad light index {idx} out of range")
        self.quad_light = idx

    def set_fog(self, sigma_t: float, albedo=(1.0, 1.0, 1.0), g: float = 0.0):
        """Global homogeneous participating medium (the reference's
        unrealized '"god rays" and fog, both via volumetric light
        transport' TODO, win32_main.cpp:159). ``sigma_t`` is the
        extinction coefficient (1/units of free flight), ``albedo`` the
        single-scatter albedo sigma_s/sigma_t per channel, ``g`` the
        Henyey-Greenstein anisotropy in (-1, 1) (0 = isotropic)."""
        if sigma_t < 0.0 or not (-1.0 < g < 1.0):
            raise ValueError("fog needs sigma_t >= 0 and -1 < g < 1")
        self.fog = (float(sigma_t), tuple(float(a) for a in albedo), float(g))

    def add_plane(self, n, d, mat) -> int:
        self.planes.append((tuple(n), float(d), int(mat)))
        return len(self.planes) - 1

    def set_mesh(self, points: np.ndarray, mat_indices: np.ndarray,
                 uvs: Optional[np.ndarray] = None):
        """points: (T*3, 3) flat vertex array, 3 consecutive verts per tri
        (mesh_t SoA convention, ray.hpp:102-106). ``uvs``: optional
        (T*3, 2) per-vertex texture coordinates in glTF [0, 1] units
        (gltf.load_gltf_textured — the reference's unrealized
        textured-materials TODO, win32_main.cpp:172). They are converted
        HERE to the texel-space convention every sampler in this framework
        uses (SampleTexture takes texel units and wraps, win32_main.cpp:
        1680-1698): each triangle's UVs scale by its material's bound
        albedo-texture size, so uv (2, 2) tiles an 8x8 texture twice.
        Materials and textures must therefore be registered before
        set_mesh; triangles without a bound texture keep scale 1 (their
        UVs are never sampled)."""
        pts = np.asarray(points, np.float32).reshape(-1, 3, 3)
        self.triangles = pts
        self.tri_mats = np.asarray(mat_indices, np.int32).reshape(-1, 3)[:, 0]
        if uvs is None:
            self.tri_uvs = None
            return
        uv = np.asarray(uvs, np.float32).reshape(-1, 3, 2)
        mw = np.ones((len(self.materials),), np.float32)
        mh = np.ones((len(self.materials),), np.float32)
        for j, m in enumerate(self.materials):
            if m.albedo_idx and m.albedo_idx <= len(self.textures):
                mh[j], mw[j] = self.textures[m.albedo_idx - 1].shape[:2]
        scale = np.stack([mw[self.tri_mats], mh[self.tri_mats]],
                         axis=-1)[:, None, :]  # (T, 1, 2)
        self.tri_uvs = (uv * scale).astype(np.float32)

    def add_texture(self, data: np.ndarray) -> int:
        """Returns the 1-based texture index used by material *_idx fields."""
        self.textures.append(np.asarray(data, np.float32))
        return len(self.textures)

    # ------------------------------------------------------------------
    def finalize(self, world_kind: int = WORLD_DEFAULT,
                 use_normal_maps: bool = True,
                 use_metalness_maps: bool = True,
                 use_roughness_maps: bool = True,
                 grid=None) -> Scene:
        """Compile host lists into a padded device Scene."""
        f32, i32 = np.float32, np.int32

        def vec_table(rows, pad_to):
            a = np.zeros((pad_to, 3), f32)
            if rows:
                a[: len(rows)] = np.asarray(rows, f32)
            return Vec3(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]), jnp.asarray(a[:, 2]))

        def scalar_table(rows, pad_to, dtype=f32, fill=0):
            a = np.full((pad_to,), fill, dtype)
            if len(rows):
                a[: len(rows)] = np.asarray(rows, dtype)
            return jnp.asarray(a)

        def mask_table(n, pad_to):
            m = np.zeros((pad_to,), bool)
            m[:n] = True
            return jnp.asarray(m)

        M = _pad(len(self.materials))
        mats = self.materials
        S, Q, P = _pad(len(self.spheres)), _pad(len(self.quads)), _pad(len(self.planes))
        ntri = 0 if self.triangles is None else len(self.triangles)
        T = _pad(ntri)

        tri_a = np.zeros((T, 3), f32)
        tri_u = np.zeros((T, 3), f32)
        tri_v = np.zeros((T, 3), f32)
        tri_m = np.zeros((T,), i32)
        if ntri:
            tri_a[:ntri] = self.triangles[:, 0]
            tri_u[:ntri] = self.triangles[:, 1] - self.triangles[:, 0]
            tri_v[:ntri] = self.triangles[:, 2] - self.triangles[:, 0]
            tri_m[:ntri] = self.tri_mats
        has_mesh_uvs = getattr(self, "tri_uvs", None) is not None and ntri > 0
        tri_uvt = np.zeros((T if has_mesh_uvs else 1, 6), f32)
        if has_mesh_uvs:
            uv = self.tri_uvs
            tri_uvt[:ntri, 0:2] = uv[:, 0]
            tri_uvt[:ntri, 2:4] = uv[:, 1] - uv[:, 0]
            tri_uvt[:ntri, 4:6] = uv[:, 2] - uv[:, 0]

        # textures: pad to common max extent (mip 0 only on device),
        # packed RGB8 per texel (values are 8-bit-grid floats, textures.py)
        K = max(1, len(self.textures))
        hmax = max([t.shape[0] for t in self.textures], default=1)
        wmax = max([t.shape[1] for t in self.textures], default=1)
        tex = np.zeros((K, hmax, wmax, 3), f32)
        tw = np.ones((K,), i32)
        th = np.ones((K,), i32)
        for k, t in enumerate(self.textures):
            tex[k, : t.shape[0], : t.shape[1]] = t
            th[k], tw[k] = t.shape[0], t.shape[1]
        q = np.clip(np.round(tex * 255.0), 0, 255).astype(np.int64)
        packed = (q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16)).astype(i32)

        # canonical-set detection: exactly 4 equal-size maps and every
        # material's texture indices are all-zero or exactly (1,2,3,4)
        combined = (
            len(self.textures) == 4
            and len({t.shape[:2] for t in self.textures}) == 1
            and all(
                (m.albedo_idx, m.metalness_idx, m.roughness_idx, m.normal_idx)
                in ((0, 0, 0, 0), (1, 2, 3, 4))
                for m in mats
            )
        )
        if combined:
            qa = [np.clip(np.round(t * 255.0), 0, 255).astype(np.int64)
                  for t in self.textures]
            alb, mtl, rgh, nrm = qa
            comb_a = (alb[..., 0] | (alb[..., 1] << 8) | (alb[..., 2] << 16)
                      | (mtl[..., 0] << 24)).astype(np.int64)
            comb_b = (nrm[..., 0] | (nrm[..., 1] << 8) | (nrm[..., 2] << 16)
                      | (rgh[..., 0] << 24)).astype(np.int64)
            # keep within int32 via wraparound-safe cast
            comb_a = comb_a.astype(np.uint32).astype(np.int64).astype(i32)
            comb_b = comb_b.astype(np.uint32).astype(np.int64).astype(i32)
            ch, cw = self.textures[0].shape[:2]

            # Mip pyramid of the combined words. The reference's
            # GenerateMipmapChain (win32_main.cpp:2307-2328) samples the
            # parent at uv=(2x,2y) — with SampleTexture's truncation that is
            # exact even-texel decimation, so level l of the 8-bit words is
            # literally comb[::2^l, ::2^l]: no filtering, no re-quantization.
            # Level 0 occupies the leading words, so every mip-0-only
            # consumer (the reference-parity default) is untouched. Built
            # only for square power-of-two sets (the reference asserts
            # square; wrap masks need pow2); ~1/3 extra memory.
            mip_meta = ()
            if ch == cw and ch >= 8 and (ch & (ch - 1)) == 0:
                metas, a_parts, b_parts = [], [], []
                word_off = 0
                lvl, wl = 0, cw
                while wl:
                    a_l = comb_a[:: 1 << lvl, :: 1 << lvl][:wl, :wl]
                    b_l = comb_b[:: 1 << lvl, :: 1 << lvl][:wl, :wl]
                    metas.append((word_off, wl, wl))
                    a_parts.append(a_l.reshape(-1))
                    b_parts.append(b_l.reshape(-1))
                    word_off += wl * wl
                    lvl, wl = lvl + 1, wl >> 1
                mip_meta = tuple(metas)
                comb_a = np.concatenate(a_parts)
                comb_b = np.concatenate(b_parts)
        else:
            comb_a = np.zeros((1,), i32)
            comb_b = np.zeros((1,), i32)
            ch = cw = 1
            mip_meta = ()

        non_tri_mats = ({s[2] for s in self.spheres}
                        | {q[3] for q in self.quads}
                        | {p[2] for p in self.planes})
        tex_mesh_only = bool(
            has_mesh_uvs and self.textures
            and all(
                m.metalness_idx == 0 and m.roughness_idx == 0
                and m.normal_idx == 0 and m.bump_idx == 0
                and (m.albedo_idx == 0 or j not in non_tri_mats)
                for j, m in enumerate(mats)))

        if grid is None:
            grid_start = jnp.zeros((1,), i32)
            grid_count = jnp.zeros((1,), i32)
            grid_tris = jnp.zeros((1,), i32)
            grid_res = 0
        else:
            grid_start, grid_count, grid_tris, grid_res = grid

        # STATIC constancy map for the material lookup (integrator
        # _material_lookup): a field whose column holds ONE value across
        # the real rows broadcasts row 0 instead of sweeping/gathering —
        # bit-identical (pure lookup) and it removes most of the sweep's
        # compare+select chains on scenes with mostly-uniform tables
        # (Cornell: metalness/ior/metal_color and every *_idx are
        # single-valued; round-5 estimator op-count pass).
        def _column(name):
            return [getattr(m, name) for m in mats]

        mat_const = tuple(sorted(
            k for k, col in dict(
                albedo=_column("albedo"), emit=_column("emit"),
                metal_color=_column("metal_color"),
                metalness=_column("metalness"),
                roughness=_column("roughness"), ior=_column("ior"),
                albedo_idx=_column("albedo_idx"),
                metalness_idx=_column("metalness_idx"),
                roughness_idx=_column("roughness_idx"),
                normal_idx=_column("normal_idx"),
                transmission=_column("transmission"),
                dispersion=_column("dispersion"),
                bump_idx=_column("bump_idx"),
                bump_scale=_column("bump_scale"),
            ).items()
            if len({tuple(np.ravel(np.asarray(x, np.float64))) for x in col})
            <= 1))

        return Scene(
            mat_const=mat_const,
            mat_albedo=vec_table([m.albedo for m in mats], M),
            mat_emit=vec_table([m.emit for m in mats], M),
            mat_metal_color=vec_table([m.metal_color for m in mats], M),
            mat_metalness=scalar_table([m.metalness for m in mats], M),
            mat_roughness=scalar_table([m.roughness for m in mats], M, fill=1),
            mat_ior=scalar_table([m.ior for m in mats], M, fill=1),
            mat_transmission=scalar_table(
                [m.transmission for m in mats], M),
            mat_dispersion=scalar_table(
                [m.dispersion for m in mats], M),
            mat_alpha=scalar_table([m.alpha for m in mats], M, fill=1),
            any_transmissive=any(m.transmission > 0.0 for m in mats),
            any_dispersive=any(m.transmission > 0.0 and m.dispersion > 0.0
                               for m in mats),
            mat_albedo_idx=scalar_table([m.albedo_idx for m in mats], M, i32),
            mat_bump_idx=scalar_table([m.bump_idx for m in mats], M, i32),
            mat_bump_scale=scalar_table([m.bump_scale for m in mats], M,
                                        fill=1),
            any_bump=any(m.bump_idx != 0 for m in mats),
            mat_metalness_idx=scalar_table([m.metalness_idx for m in mats], M, i32),
            mat_roughness_idx=scalar_table([m.roughness_idx for m in mats], M, i32),
            mat_normal_idx=scalar_table([m.normal_idx for m in mats], M, i32),
            sph_center=vec_table([s[0] for s in self.spheres], S),
            sph_radius=scalar_table([s[1] for s in self.spheres], S),
            sph_mat=scalar_table([s[2] for s in self.spheres], S, i32),
            sph_mask=mask_table(len(self.spheres), S),
            quad_point=vec_table([q[0] for q in self.quads], Q),
            quad_u=vec_table([q[1] for q in self.quads], Q),
            quad_v=vec_table([q[2] for q in self.quads], Q),
            quad_mat=scalar_table([q[3] for q in self.quads], Q, i32),
            quad_mask=mask_table(len(self.quads), Q),
            quad_n=_bake_quad_normals(
                vec_table([q[1] for q in self.quads], Q),
                vec_table([q[2] for q in self.quads], Q)),
            pln_n=vec_table([p[0] for p in self.planes], P),
            pln_d=scalar_table([p[1] for p in self.planes], P),
            pln_mat=scalar_table([p[2] for p in self.planes], P, i32),
            pln_mask=mask_table(len(self.planes), P),
            tri_a=Vec3(jnp.asarray(tri_a[:, 0]), jnp.asarray(tri_a[:, 1]), jnp.asarray(tri_a[:, 2])),
            tri_u=Vec3(jnp.asarray(tri_u[:, 0]), jnp.asarray(tri_u[:, 1]), jnp.asarray(tri_u[:, 2])),
            tri_v=Vec3(jnp.asarray(tri_v[:, 0]), jnp.asarray(tri_v[:, 1]), jnp.asarray(tri_v[:, 2])),
            tri_mat=jnp.asarray(tri_m),
            tri_mask=mask_table(ntri, T),
            tri_uv0u=jnp.asarray(tri_uvt[:, 0]),
            tri_uv0v=jnp.asarray(tri_uvt[:, 1]),
            tri_uvdu1=jnp.asarray(tri_uvt[:, 2]),
            tri_uvdv1=jnp.asarray(tri_uvt[:, 3]),
            tri_uvdu2=jnp.asarray(tri_uvt[:, 4]),
            tri_uvdv2=jnp.asarray(tri_uvt[:, 5]),
            has_mesh_uvs=has_mesh_uvs,
            box_min=vec_table([], 8),
            box_max=vec_table([], 8),
            box_mat=scalar_table([], 8, i32),
            box_mask=mask_table(0, 8),
            light_kind=scalar_table([l[0] for l in self.lights], _pad(len(self.lights)), i32),
            light_vec=vec_table([l[1] for l in self.lights], _pad(len(self.lights))),
            light_radiance=vec_table([l[2] for l in self.lights], _pad(len(self.lights))),
            light_mask=mask_table(len(self.lights), _pad(len(self.lights))),
            grid_cell_start=grid_start,
            grid_cell_count=grid_count,
            grid_tris=grid_tris,
            tex_packed=jnp.asarray(packed.reshape(-1)),
            tex_w=jnp.asarray(tw),
            tex_h=jnp.asarray(th),
            tex_comb_a=jnp.asarray(np.asarray(comb_a).reshape(-1)),
            tex_comb_b=jnp.asarray(np.asarray(comb_b).reshape(-1)),
            tex_hmax=hmax,
            tex_wmax=wmax,
            tex_combined=bool(combined),
            tex_comb_w=cw,
            tex_comb_h=ch,
            tex_mip_meta=mip_meta,
            tex_mesh_only=tex_mesh_only,
            world_kind=world_kind,
            just_cosine=(world_kind == WORLD_RAYTRACING_ONE_WEEKEND),
            quad_light=self.quad_light,
            tbn_normal_maps=self.tbn_normal_maps,
            fog_sigma_t=self.fog[0],
            fog_albedo=self.fog[1],
            fog_g=self.fog[2],
            n_spheres=len(self.spheres),
            n_quads=len(self.quads),
            n_planes=len(self.planes),
            n_tris=ntri,
            n_boxes=0,
            n_materials=len(mats),
            n_textures=len(self.textures),
            grid_res=grid_res,
            use_normal_maps=use_normal_maps,
            use_metalness_maps=use_metalness_maps,
            use_roughness_maps=use_roughness_maps,
        )
