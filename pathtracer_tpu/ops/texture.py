"""Batched texture sampling (bilinear, wrap) from the device texture stack.

Reference semantics:
- SampleTexture (win32_main.cpp:1680-1709): uv in texel units; abs(uv);
  integer truncation; fractional weights clamped to [0,1]; wraparound on
  both axes; bilinear blend.
- BespokeSampleTexture (win32_main.cpp:1675-1678): world-space planar
  mapping uv_texels = (u * width * 0.5, v * height * 0.5) — the "bespoke"
  scale used by every material texture fetch in the reference
  (win32_main.cpp:613,621,631,640,1604).

Layout: texels are packed RGB8 in ONE flat int32 array (Scene.tex_packed,
linear index (layer*Hmax + y)*Wmax + x). Random-access gathers dominate
textured-scene cost; packing turns 3 float gathers per texel into 1 int32
gather, and the flat 1-D index keeps every fetch a 1-D gather. Texel floats are exactly the
reference's k/255 values (textures are always 8-bit-sourced: stbi_load ->
/255.f, win32_main.cpp:1736-1739; procedural stand-ins are quantized to the
same grid, scene/textures.quantize8) so the CPU oracle matches bit-for-bit.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..scene.schema import Scene
from ..utils.vec import Vec3

_INV255 = 1.0 / 255.0


def _unpack(word: jnp.ndarray) -> Vec3:
    """Packed RGB8 int32 -> float Vec3, the reference's unpack semantics
    (pixel & 0xFF, >>8, >>16 each * 1/255 — win32_main.cpp:1736-1739)."""
    r = (word & 0xFF).astype(jnp.float32) * _INV255
    g = ((word >> 8) & 0xFF).astype(jnp.float32) * _INV255
    b = ((word >> 16) & 0xFF).astype(jnp.float32) * _INV255
    return Vec3(r, g, b)


def sample_texture(scene: Scene, layer: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray) -> Vec3:
    """Bilinear-wrap sample. ``layer`` is the 0-based texture layer per lane,
    (u, v) are texel-space coordinates per lane."""
    w = scene.tex_w[layer]
    h = scene.tex_h[layer]
    u = jnp.abs(u)
    v = jnp.abs(v)
    x1 = u.astype(jnp.int32)
    y1 = v.astype(jnp.int32)
    s = jnp.clip(u - x1.astype(u.dtype), 0.0, 1.0)
    t = jnp.clip(v - y1.astype(v.dtype), 0.0, 1.0)
    x1 = x1 % w
    x2 = (x1 + 1) % w
    y1 = y1 % h
    y2 = (y1 + 1) % h

    base = layer * (scene.tex_hmax * scene.tex_wmax)

    def fetch(yy, xx):
        return _unpack(scene.tex_packed[base + yy * scene.tex_wmax + xx])

    c11, c12 = fetch(y1, x1), fetch(y1, x2)
    c21, c22 = fetch(y2, x1), fetch(y2, x2)
    return _bilerp_vec3(c11, c12, c21, c22, s, t)


def _bilerp_vec3(c11: Vec3, c12: Vec3, c21: Vec3, c22: Vec3, s, t) -> Vec3:
    """Bilinear blend of four Vec3 corners — the exact f32 expression of
    SampleTexture's blend (win32_main.cpp:1699-1708)."""
    top = Vec3(
        (1 - s) * c11.x + s * c12.x,
        (1 - s) * c11.y + s * c12.y,
        (1 - s) * c11.z + s * c12.z,
    )
    bot = Vec3(
        (1 - s) * c21.x + s * c22.x,
        (1 - s) * c21.y + s * c22.y,
        (1 - s) * c21.z + s * c22.z,
    )
    return Vec3(
        (1 - t) * top.x + t * bot.x,
        (1 - t) * top.y + t * bot.y,
        (1 - t) * top.z + t * bot.z,
    )


def bespoke_sample(scene: Scene, layer: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray) -> Vec3:
    """BespokeSampleTexture: scale world-plane (u,v) by size/2 then sample."""
    w = scene.tex_w[layer].astype(u.dtype)
    h = scene.tex_h[layer].astype(v.dtype)
    return sample_texture(scene, layer, u * w * 0.5, v * h * 0.5)


def _unpack4(word: jnp.ndarray):
    """Packed RGBX8 int32 -> (r, g, b, x) floats. The >>24 byte survives the
    int32 sign because & 0xFF masks the sign-extension bits."""
    r = (word & 0xFF).astype(jnp.float32) * _INV255
    g = ((word >> 8) & 0xFF).astype(jnp.float32) * _INV255
    b = ((word >> 16) & 0xFF).astype(jnp.float32) * _INV255
    x = ((word >> 24) & 0xFF).astype(jnp.float32) * _INV255
    return r, g, b, x


def _combined_coords(scene: Scene, u: jnp.ndarray, v: jnp.ndarray):
    """Bespoke-scale uv -> bilinear corner coordinates + fractional weights
    (SampleTexture truncation/wrap semantics, win32_main.cpp:1680-1698)."""
    w, h = scene.tex_comb_w, scene.tex_comb_h
    u = jnp.abs(u * (w * 0.5))
    v = jnp.abs(v * (h * 0.5))
    x1 = u.astype(jnp.int32)
    y1 = v.astype(jnp.int32)
    s = jnp.clip(u - x1.astype(u.dtype), 0.0, 1.0)
    t = jnp.clip(v - y1.astype(v.dtype), 0.0, 1.0)
    x1 = x1 % w
    x2 = (x1 + 1) % w
    y1 = y1 % h
    y2 = (y1 + 1) % h
    return x1, y1, x2, y2, s, t


def _mip_select(scene: Scene, lod: jnp.ndarray):
    """Per-lane (word_off, w, h) for the mip level each lane selected — a
    select sweep over the static pyramid table (Scene.tex_mip_meta, ~10
    levels)."""
    meta = scene.tex_mip_meta
    out = []
    for j in range(3):
        acc = jnp.full(lod.shape, meta[0][j], jnp.int32)
        for l in range(1, len(meta)):
            acc = jnp.where(lod == l, jnp.int32(meta[l][j]), acc)
        out.append(acc)
    return tuple(out)


def _combined_coords_mip(scene: Scene, u: jnp.ndarray, v: jnp.ndarray,
                         lod: jnp.ndarray):
    """Mip-aware twin of :func:`_combined_coords`: same truncation/wrap
    semantics evaluated at each lane's pyramid level (sizes are pow2 —
    schema gates the pyramid on it — so wrap is a mask, not a modulo).
    The bespoke scale uses the LEVEL's size, exactly what the reference's
    BespokeSampleTexture would do handed mips[lod] (win32_main.cpp:1675)."""
    word_off, w, h = _mip_select(scene, lod)
    u = jnp.abs(u * (w.astype(u.dtype) * 0.5))
    v = jnp.abs(v * (h.astype(v.dtype) * 0.5))
    x1 = u.astype(jnp.int32)
    y1 = v.astype(jnp.int32)
    s = jnp.clip(u - x1.astype(u.dtype), 0.0, 1.0)
    t = jnp.clip(v - y1.astype(v.dtype), 0.0, 1.0)
    wm, hm = w - 1, h - 1
    x1 = x1 & wm
    x2 = (x1 + 1) & wm
    y1 = y1 & hm
    y2 = (y1 + 1) & hm
    return x1, y1, x2, y2, s, t, word_off, w


def bespoke_sample_combined_mip(scene: Scene, u: jnp.ndarray,
                                v: jnp.ndarray, lod: jnp.ndarray):
    """Mip fetch: flat gathers from the concatenated word pyramid (level 0
    leads, so lod==0 reads the exact mip-0 words)."""
    x1, y1, x2, y2, s, t, word_off, w = _combined_coords_mip(scene, u, v, lod)

    def corners(plane):
        return (plane[word_off + y1 * w + x1],
                plane[word_off + y1 * w + x2],
                plane[word_off + y2 * w + x1],
                plane[word_off + y2 * w + x2])

    return _blend_combined(corners(scene.tex_comb_a),
                           corners(scene.tex_comb_b), s, t)


def _blend_combined(wa, wb, s, t):
    """Bilinear blend of the 4 corner word-pairs. ``wa``/``wb`` are
    (c11, c12, c21, c22) packed A/B words; the same expression as the
    oracle's blend. Returns (albedo Vec3, metalness, roughness, normal
    Vec3)."""

    def bilerp(c11, c12, c21, c22):
        top = (1 - s) * c11 + s * c12
        bot = (1 - s) * c21 + s * c22
        return (1 - t) * top + t * bot

    def blend4(ws):
        ch = [_unpack4(w_) for w_ in ws]
        return tuple(bilerp(ch[0][i], ch[1][i], ch[2][i], ch[3][i])
                     for i in range(4))

    ar, ag, ab, met = blend4(wa)
    nr, ng, nb, rgh = blend4(wb)
    return Vec3(ar, ag, ab), met, rgh, Vec3(nr, ng, nb)


def bespoke_sample_combined(scene: Scene, u: jnp.ndarray, v: jnp.ndarray):
    """Fused bespoke sample of the canonical 4-map set (scene.tex_combined):
    ONE pair of gathers per bilinear corner decodes albedo+metalness and
    normal+roughness together — 8 gathers/bounce instead of 16. Bilinear
    math is the same expression per channel as sample_texture, so values
    are bit-identical to four separate fetches (and to the oracle).

    Returns (albedo Vec3, metalness, roughness, normal Vec3).
    """
    w = scene.tex_comb_w
    x1, y1, x2, y2, s, t = _combined_coords(scene, u, v)

    def corners(plane):
        c11 = plane[y1 * w + x1]
        c12 = plane[y1 * w + x2]
        c21 = plane[y2 * w + x1]
        c22 = plane[y2 * w + x2]
        return c11, c12, c21, c22

    return _blend_combined(corners(scene.tex_comb_a),
                           corners(scene.tex_comb_b), s, t)
