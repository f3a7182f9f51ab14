"""Mesh-UV textured materials — the reference's unrealized "load
materials with textures" TODO (win32_main.cpp:172): glTF baseColorTexture
+ TEXCOORD_0 ingestion (gltf.load_gltf_textured), winner-hit UV
interpolation (ops/intersect.intersect_scene_uv), and the
texel-modulates-albedo shading branch, golden-gated against the oracle."""

import io
import json
import struct

import numpy as np
import pytest

from pathtracer_tpu.render.renderer import RenderConfig, render_image
from pathtracer_tpu.reference.cpu_oracle import render_oracle
from pathtracer_tpu.scene.camera import define_camera
from pathtracer_tpu.scene.gltf import load_gltf_textured, load_gltf_triangles
from pathtracer_tpu.scene.schema import WorldBuilder


def _checker(n=8):
    c = np.indices((n, n)).sum(0) % 2
    tex = np.stack([c * (200 / 255.0) + 30 / 255.0] * 3, -1)
    tex[..., 2] *= 0.25
    return tex.astype(np.float32)


def _textured_glb(tmp_path, factor=(1.0, 1.0, 1.0)):
    """Two-triangle quad with TEXCOORD_0 + an embedded PNG texture."""
    from PIL import Image
    pos = np.array([[-2, 0, -1], [2, 0, -1], [2, 0, 3], [-2, 0, 3]],
                   np.float32)
    uv = np.array([[0, 0], [2, 0], [2, 2], [0, 2]], np.float32)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    png = io.BytesIO()
    Image.fromarray((_checker() * 255).round().astype(np.uint8)).save(
        png, format="PNG")
    png = png.getvalue()

    blob = pos.tobytes() + uv.tobytes() + idx.tobytes() + png
    views = [
        {"buffer": 0, "byteOffset": 0, "byteLength": pos.nbytes},
        {"buffer": 0, "byteOffset": pos.nbytes, "byteLength": uv.nbytes},
        {"buffer": 0, "byteOffset": pos.nbytes + uv.nbytes,
         "byteLength": idx.nbytes},
        {"buffer": 0, "byteOffset": pos.nbytes + uv.nbytes + idx.nbytes,
         "byteLength": len(png)},
    ]
    doc = {
        "asset": {"version": "2.0"},
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0, "TEXCOORD_0": 1},
            "indices": 2, "material": 0,
        }]}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorTexture": {"index": 0},
            "baseColorFactor": list(factor) + [1.0],
        }}],
        "textures": [{"source": 0}],
        "images": [{"bufferView": 3, "mimeType": "image/png"}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4,
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 4,
             "type": "VEC2"},
            {"bufferView": 2, "componentType": 5123, "count": 6,
             "type": "SCALAR"},
        ],
        "bufferViews": views,
        "buffers": [{"byteLength": len(blob)}],
    }
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    blob += b"\0" * (-len(blob) % 4)
    glb = (struct.pack("<III", 0x46546C67, 2, 12 + 8 + len(js) + 8 + len(blob))
           + struct.pack("<II", len(js), 0x4E4F534A) + js
           + struct.pack("<II", len(blob), 0x004E4942) + blob)
    p = str(tmp_path / "tex.glb")
    with open(p, "wb") as f:
        f.write(glb)
    return p


class TestGltfTextured:
    def test_loader_binds_texture_and_uvs(self, tmp_path):
        p = _textured_glb(tmp_path, factor=(0.5, 1.0, 0.25))
        b = WorldBuilder()
        b.add_material(emit=(0.1, 0.1, 0.1))
        b.add_material(emit=(5, 5, 5))
        pts, mats, uvs = load_gltf_textured(p, b)
        assert pts.shape == (6, 3) and uvs.shape == (6, 2)
        assert len(b.textures) == 1
        # vs the PNG's actual 8-bit payload (the checker's blue channel is
        # off the 8-bit grid and rounds at encode time)
        np.testing.assert_allclose(
            b.textures[0], np.round(_checker() * 255.0) / 255.0, atol=1e-7)
        m = b.materials[mats[0]]
        assert m.albedo_idx == 1  # bound to the loaded texture
        np.testing.assert_allclose(m.albedo, (0.5, 1.0, 0.25))
        np.testing.assert_allclose(uvs[:3], [[0, 0], [2, 0], [2, 2]])

    def test_uvs_scale_to_texel_space(self, tmp_path):
        """set_mesh converts glTF [0, 1] UVs to the texel-unit convention
        every sampler uses (SampleTexture wraps texel coords,
        win32_main.cpp:1680-1698): uv (2, 2) on the 8x8 checker must land
        at texel 16 — the texture tiles twice across the quad, not once
        across its first two texels."""
        p = _textured_glb(tmp_path)
        b = WorldBuilder()
        b.add_material(emit=(0.1, 0.1, 0.1))
        b.add_material(emit=(5, 5, 5))
        pts, mats, uvs = load_gltf_textured(p, b)
        b.set_mesh(pts, mats, uvs=uvs)
        np.testing.assert_allclose(b.tri_uvs[0], uvs[:3] * 8.0)
        scene = b.finalize()
        # device tables carry the scaled uv0 + edge deltas
        np.testing.assert_allclose(np.asarray(scene.tri_uv0u)[:2], [0.0, 0.0])
        np.testing.assert_allclose(np.asarray(scene.tri_uvdu1)[0], 16.0)

    def test_plain_loader_keeps_reference_quirk(self, tmp_path):
        """load_gltf_triangles on a textured doc must keep mat_idx = 1
        (the reference default, win32_main.cpp:1504) and load no image."""
        p = _textured_glb(tmp_path)
        b = WorldBuilder()
        b.add_material(emit=(0.1, 0.1, 0.1))
        b.add_material(emit=(5, 5, 5))
        pts, mats = load_gltf_triangles(p, b)
        assert pts.shape == (6, 3)
        assert (mats == 1).all()
        assert len(b.textures) == 0

    def test_end_to_end_matches_oracle(self, tmp_path):
        """Full pipeline: textured GLB -> WorldBuilder -> renderer vs the
        scalar oracle (which interpolates the same per-vertex UVs)."""
        p = _textured_glb(tmp_path, factor=(1.0, 0.9, 0.8))
        b = WorldBuilder()
        b.add_material(emit=(0.3, 0.35, 0.45))
        light = b.add_material(emit=(6.0, 5.5, 5.0))
        b.add_sphere((3, -3, 6), 1.0, light)
        pts, mats, uvs = load_gltf_textured(p, b)
        b.set_mesh(pts, mats, uvs=uvs)
        floor = b.add_material(albedo=(0.5, 0.45, 0.4), roughness=0.9)
        b.add_plane((0, 0, 1), 1.5, floor)
        scene = b.finalize()
        assert scene.has_mesh_uvs
        w, h, pp = 16, 12, 2
        cam = define_camera((0, -8, 1), (0, 0, 1), 35.0, w, h)
        cfg = RenderConfig(width=w, height=h, pp=pp, seed=3)
        img, _, _ = render_image(scene, cam, cfg)
        oracle = render_oracle(b, cam, w, h, pp, seed=3, world_kind=0)
        img = np.asarray(img)
        d = np.abs(img - oracle).max(axis=-1)
        assert np.median(d) < 1e-4, float(np.median(d))
        assert (d > 1e-2).mean() < 0.05, float((d > 1e-2).mean())
        # the checker must actually be visible (texture varies the image)
        assert img.std() > 0.01

    def test_mesh_only_flag(self, tmp_path):
        """tex_mesh_only (every textured material is a triangle-albedo
        binding) lets shade_bounce skip the bespoke planar fetches; a
        texture bound to a non-triangle primitive keeps them live."""
        p = _textured_glb(tmp_path)
        b = WorldBuilder()
        b.add_material(emit=(0.1, 0.1, 0.1))
        b.add_material(emit=(5, 5, 5))
        pts, mats, uvs = load_gltf_textured(p, b)
        b.set_mesh(pts, mats, uvs=uvs)
        scene = b.finalize()
        assert scene.has_mesh_uvs and scene.tex_mesh_only

        # texture bound to a PLANE material: planar fetches stay live
        b3 = WorldBuilder()
        b3.add_material(emit=(0.1, 0.1, 0.1))
        b3.add_material(emit=(5, 5, 5))
        pts3, mats3, uvs3 = load_gltf_textured(p, b3)
        b3.set_mesh(pts3, mats3, uvs=uvs3)
        ti3 = b3.add_texture(np.full((8, 8, 3), 0.5, np.float32))
        pm = b3.add_material(albedo=(1, 1, 1), albedo_idx=ti3)
        b3.add_plane((0, 0, 1), 1.5, pm)
        s3 = b3.finalize()
        assert s3.has_mesh_uvs and not s3.tex_mesh_only

    def test_sharded_matches_single_on_uv_scene(self, tmp_path):
        """The mesh-UV scene over a 4-device mesh: every pixel's samples
        are a pure function of its index, so the sharded render equals
        the single-device one up to XLA:CPU's shape-dependent fma
        rounding in the uv interpolation."""
        import jax
        from pathtracer_tpu.parallel.shard import (
            make_mesh, render_image_sharded,
        )
        p = _textured_glb(tmp_path, factor=(1.0, 0.9, 0.8))
        b = WorldBuilder()
        b.add_material(emit=(0.3, 0.35, 0.45))
        light = b.add_material(emit=(6.0, 5.5, 5.0))
        b.add_sphere((3, -3, 6), 1.0, light)
        pts, mats, uvs = load_gltf_textured(p, b)
        b.set_mesh(pts, mats, uvs=uvs)
        floor = b.add_material(albedo=(0.5, 0.45, 0.4), roughness=0.9)
        b.add_plane((0, 0, 1), 1.5, floor)
        scene = b.finalize()
        w, h = 16, 12
        cfg = RenderConfig(width=w, height=h, pp=2, seed=3)
        cam = define_camera((0, -8, 1), (0, 0, 1), 35.0, w, h)
        single, _, _ = render_image(scene, cam, cfg)
        sharded, _, _ = render_image_sharded(
            scene, cam, cfg, mesh=make_mesh(jax.devices()[:4]))
        d = np.abs(np.asarray(single) - np.asarray(sharded))
        assert (d == 0).mean() > 0.8 and d.max() < 1e-4, float(d.max())

    def test_multi_layer_stack_matches_oracle(self):
        """Two textures of DIFFERENT sizes (16x8 and 32x32) in one stack:
        the per-lane layer index must route each triangle's lanes to its
        own texture (flat gathers over the padded stack), matching the
        oracle."""
        rng = np.random.default_rng(0)
        b = WorldBuilder()
        b.add_material(emit=(0.3, 0.35, 0.45))
        light = b.add_material(emit=(6.0, 5.5, 5.0))
        b.add_sphere((3, -3, 6), 1.0, light)
        t1 = (np.round(rng.uniform(0, 1, (8, 16, 3)) * 255) / 255
              ).astype(np.float32)
        t2 = (np.round(rng.uniform(0, 1, (32, 32, 3)) * 255) / 255
              ).astype(np.float32)
        m1 = b.add_material(albedo=(1.0, 0.9, 0.8),
                            albedo_idx=b.add_texture(t1), roughness=0.7)
        m2 = b.add_material(albedo=(0.8, 1.0, 0.9),
                            albedo_idx=b.add_texture(t2), roughness=0.4)
        pts = np.array([[-2, 0, -1], [2, 0, -1], [2, 0, 3],
                        [-2, 0, -1], [2, 0, 3], [-2, 0, 3],
                        [-4, 1, -1], [-2.5, 1, -1], [-2.5, 1, 2]],
                       np.float32)
        mats = np.array([m1] * 6 + [m2] * 3, np.int32)
        uvs = np.array([[0, 0], [2, 0], [2, 2], [0, 0], [2, 2], [0, 2],
                        [0, 0], [1, 0], [1, 1]], np.float32)
        b.set_mesh(pts, mats, uvs=uvs)
        floor = b.add_material(albedo=(0.5, 0.45, 0.4), roughness=0.9)
        b.add_plane((0, 0, 1), 1.5, floor)
        scene = b.finalize()
        assert scene.tex_hmax == 32 and scene.tex_wmax == 32
        w, h = 16, 12
        cfg = RenderConfig(width=w, height=h, pp=2, seed=3)
        cam = define_camera((0, -8, 1), (0, 0, 1), 35.0, w, h)
        img, _, _ = render_image(scene, cam, cfg)
        oracle = render_oracle(b, cam, w, h, 2, seed=3, world_kind=0)
        d = np.abs(np.asarray(img) - oracle).max(axis=-1)
        assert np.median(d) < 1e-4, float(np.median(d))
        assert (d > 1e-2).mean() < 0.05, float((d > 1e-2).mean())

    def test_malformed_files_no_op(self, tmp_path):
        """Truncated or byte-corrupted containers must silently no-op —
        the reference returns early when cgltf fails (win32_main.cpp:
        1464-1465) — including rolling back any materials/textures
        appended before the failure (a bad embedded image is discovered
        mid-walk)."""
        p = _textured_glb(tmp_path)
        data = open(p, "rb").read()
        rng = np.random.RandomState(0)
        cases = [data[:c] for c in (0, 4, 12, 20, 50, 100,
                                    len(data) // 2, len(data) - 40)]
        for _ in range(25):
            buf = bytearray(data)
            for _ in range(8):
                buf[rng.randint(20, len(buf))] = rng.randint(256)
            cases.append(bytes(buf))
        for i, payload in enumerate(cases):
            q = str(tmp_path / f"fuzz{i}.glb")
            with open(q, "wb") as f:
                f.write(payload)
            b = WorldBuilder()
            b.add_material(emit=(0.1, 0.1, 0.1))
            pts, mats, uvs = load_gltf_textured(q, b)  # must not raise
            if pts is None:
                assert len(b.materials) == 1 and len(b.textures) == 0, \
                    f"builder leak on case {i}"

    def test_cyclic_node_graph_no_ops(self, tmp_path):
        """A node-graph CYCLE (malformed input) must terminate as a
        silent no-op like every other malformed file — non-termination
        would escape the loader's exception-based contract (the visit
        budget raises into the catch-all)."""
        docs = [
            {"asset": {"version": "2.0"}, "scenes": [{"nodes": [0]}],
             "nodes": [{"children": [0]}]},  # self-loop
            {"asset": {"version": "2.0"}, "scenes": [{"nodes": [0]}],
             "nodes": [{"children": [1]}, {"children": [0]}]},  # 2-cycle
        ]
        for i, doc in enumerate(docs):
            p = str(tmp_path / f"cycle{i}.gltf")
            with open(p, "w") as f:
                json.dump(doc, f)
            b = WorldBuilder()
            b.add_material(emit=(0.1, 0.1, 0.1))
            pts, mats, uvs = load_gltf_textured(p, b)  # must return
            assert pts is None
            assert len(b.materials) == 1 and len(b.textures) == 0

    def test_node_transforms_baked(self, tmp_path):
        """apply_transforms bakes the node hierarchy's world matrices —
        the reference's 'instance transforms' TODO (win32_main.cpp:189):
        the same mesh instanced under two nodes (one TRS, one matrix,
        under a translating parent) lands at hand-computed positions;
        OFF keeps the reference's ignore-transforms parity."""
        pos = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
        blob = pos.tobytes()
        doc = {
            "asset": {"version": "2.0"},
            "scenes": [{"nodes": [0]}],
            "nodes": [
                {"translation": [10, 0, 0], "children": [1, 2]},
                {"mesh": 0, "scale": [2, 2, 2]},
                # column-major matrix: translate by (0, 5, 0)
                {"mesh": 0, "matrix": [1, 0, 0, 0, 0, 1, 0, 0,
                                       0, 0, 1, 0, 0, 5, 0, 1]},
            ],
            "meshes": [{"primitives": [{"attributes": {"POSITION": 0}}]}],
            "accessors": [{"bufferView": 0, "componentType": 5126,
                           "count": 3, "type": "VEC3"}],
            "bufferViews": [{"buffer": 0, "byteOffset": 0,
                             "byteLength": len(blob)}],
            "buffers": [{"byteLength": len(blob)}],
        }
        import base64
        doc["buffers"][0]["uri"] = ("data:application/octet-stream;base64,"
                                    + base64.b64encode(blob).decode())
        p = str(tmp_path / "inst.gltf")
        with open(p, "w") as f:
            json.dump(doc, f)
        from pathtracer_tpu.scene.gltf import load_gltf_textured as lgt
        b = WorldBuilder()
        b.add_material(emit=(0, 0, 0))
        b.add_material(emit=(1, 1, 1))
        pts, _, _ = lgt(p, b, apply_transforms=True)
        assert pts.shape == (6, 3)
        got = {tuple(np.round(v, 5)) for v in pts}
        expect = {tuple(v) for v in
                  np.concatenate([pos * 2 + [10, 0, 0],
                                  pos + [10, 5, 0]])}
        assert got == expect, (got, expect)
        # parity: transforms ignored by default
        pts_raw, _, _ = lgt(p, WorldBuilder())
        assert {tuple(v) for v in pts_raw} == {tuple(v) for v in pos}

    def test_wavefront_matches_unrolled_on_uv_scene(self, tmp_path):
        """Driver agreement on a UV scene. NOT asserted bit-equal: the uv
        interpolation's gather + mul + add chain contracts to fma
        differently between the unrolled and while-loop compilations
        (measured max diff 1 ulp on ~7% of pixels); the oracle golden is
        the absolute gate."""
        p = _textured_glb(tmp_path)
        b = WorldBuilder()
        b.add_material(emit=(0.3, 0.35, 0.45))
        light = b.add_material(emit=(6.0, 5.5, 5.0))
        b.add_sphere((3, -3, 6), 1.0, light)
        pts, mats, uvs = load_gltf_textured(p, b)
        b.set_mesh(pts, mats, uvs=uvs)
        scene = b.finalize()
        cam = define_camera((0, -8, 1), (0, 0, 1), 35.0, 16, 12)
        imgs = []
        for mode in ("unrolled", "wavefront"):
            cfg = RenderConfig(width=16, height=12, pp=2, seed=5, mode=mode)
            img, _, _ = render_image(scene, cam, cfg)
            imgs.append(np.asarray(img))
        np.testing.assert_allclose(imgs[0], imgs[1], atol=2e-7)


def _uv_mesh_builder(n, seed=7, tex_size=16):
    """Random n-triangle mesh with per-vertex UVs + a pow2 texture."""
    rng = np.random.RandomState(seed)
    b = WorldBuilder()
    b.add_material(emit=(0.3, 0.35, 0.45))
    light = b.add_material(emit=(6.0, 5.5, 5.0))
    b.add_sphere((6, -5, 9), 1.2, light)
    tex = (np.round(rng.rand(tex_size, tex_size, 3) * 255) / 255
           ).astype(np.float32)
    m = b.add_material(albedo=(0.9, 0.85, 0.8), roughness=0.8,
                       albedo_idx=b.add_texture(tex))
    base = (rng.rand(n, 1, 3) - 0.5) * 16.0
    tris = base + (rng.rand(n, 3, 3) - 0.5) * 1.0
    uvs = rng.rand(n * 3, 2).astype(np.float32) * 2.0
    b.set_mesh(tris.reshape(-1, 3).astype(np.float32),
               np.full((3 * n,), m, np.int32), uvs=uvs)
    return b


def _rays(rng, n=1024):
    from pathtracer_tpu.utils.vec import Vec3
    import jax.numpy as jnp
    o1 = [(rng.rand(n) - 0.5) * 24.0 for _ in range(3)]
    d_np = rng.randn(3, n).astype(np.float32)
    d_np /= np.linalg.norm(d_np, axis=0, keepdims=True)
    rs = lambda a: jnp.asarray(np.asarray(a, np.float32))
    return (Vec3(*(rs(x) for x in o1)), Vec3(*(rs(x) for x in d_np)))


class TestUVPassMatchesPlainPass:
    """intersect_scene_uv carries the winner's interpolated uv through the
    triangle loop; its hit (t, mat, normal) must equal intersect_scene's
    bit for bit, on the unrolled (<= 192 tris) and chunked loops."""

    @pytest.mark.parametrize("n_tris", [200, 1500])
    def test_hit_bit_equal_and_uv_in_range(self, n_tris):
        from pathtracer_tpu.ops import intersect as isect
        scene = _uv_mesh_builder(n_tris).finalize()
        o, d = _rays(np.random.RandomState(11))
        hu, ux, uy, ok = isect.intersect_scene_uv(scene, o, d)
        hp = isect.intersect_scene(scene, o, d)
        for a, b_ in ((hu.t, hp.t), (hu.mat, hp.mat), (hu.normal.x, hp.normal.x),
                      (hu.normal.z, hp.normal.z)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b_))
        ok = np.asarray(ok)
        assert ok.any()
        # winners are triangles exactly where the plain pass hit one:
        # uvs of the 16x16 texture scaled by 2 stay within [0, 32]
        ux = np.asarray(ux)[ok]
        assert (ux >= -1e-3).all() and (ux <= 32 + 1e-3).all()

    def test_large_uv_mesh_matches_oracle(self):
        """End-to-end: a 1500-tri UV-textured mesh (chunked brute-force
        loop + flat texel gathers) vs the scalar oracle."""
        from pathtracer_tpu.scene.camera import define_camera
        b = _uv_mesh_builder(1500)
        scene = b.finalize()
        w, h, pp = 16, 8, 2
        cam = define_camera((0, -24, 2), (0, 0, 0), 35.0, w, h)
        cfg = RenderConfig(width=w, height=h, pp=pp, seed=2)
        img, _, _ = render_image(scene, cam, cfg)
        oracle = render_oracle(b, cam, w, h, pp, seed=2, world_kind=0)
        dmax = np.abs(np.asarray(img) - oracle).max(axis=-1)
        assert np.median(dmax) < 1e-4, float(np.median(dmax))
        assert (dmax > 1e-2).mean() < 0.05, float((dmax > 1e-2).mean())
