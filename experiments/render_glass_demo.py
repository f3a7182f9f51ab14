"""Render the dielectric-glass demo scene to images/glass.png.

The scene from tests/test_refraction.py (glass sphere, ior 1.5, over a
rough floor with an NEE light) at gallery quality. Run on the GPU:
    python experiments/render_glass_demo.py [SPP] [WxH]
"""
import sys

import numpy as np

from pathtracer_tpu.render.renderer import RenderConfig, render_image
from pathtracer_tpu.scene.camera import define_camera
from pathtracer_tpu.scene.schema import WorldBuilder

spp = int(sys.argv[1]) if len(sys.argv) > 1 else 256
size = sys.argv[2] if len(sys.argv) > 2 else "1280x720"
w, h = (int(x) for x in size.split("x"))

b = WorldBuilder()
b.add_material(emit=(0.35, 0.45, 0.6))
light = b.add_material(emit=(8.0, 7.0, 6.0))
b.add_sphere((3.0, -2.0, 5.0), 1.0, light)
glass = b.add_material(albedo=(0.95, 0.97, 0.99), ior=1.5, transmission=1.0)
b.add_sphere((0.0, 0.0, 1.2), 1.1, glass)
red = b.add_material(albedo=(0.7, 0.15, 0.1), roughness=0.6)
b.add_sphere((-2.4, 1.5, 0.8), 0.8, red)
metal = b.add_material(albedo=(0.2, 0.2, 0.2), metal_color=(0.9, 0.7, 0.3),
                       metalness=1.0, roughness=0.15)
b.add_sphere((2.3, 1.8, 0.9), 0.9, metal)
floor = b.add_material(albedo=(0.55, 0.5, 0.45), roughness=0.9)
b.add_plane((0, 0, 1), 0.0, floor)

scene = b.finalize()
camera = define_camera((0, -7, 1.8), (0, 0, 1), 35.0, w, h)
pp = int(round(spp ** 0.5))
cfg = RenderConfig(width=w, height=h, pp=pp, seed=0)

img, packed, st = render_image(scene, camera, cfg, chunk_samples=64)
packed = np.asarray(packed)
from pathtracer_tpu.io.bmp import packed_to_rgb
from PIL import Image
Image.fromarray(packed_to_rgb(packed)[::-1]).save("images/glass.png")
print("wrote images/glass.png",
      float(np.asarray(st.rays_cast)) / 1e6, "Mrays")
