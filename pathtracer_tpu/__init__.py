"""pathtracer_tpu: a wavefront path tracer in JAX, run on NVIDIA GPUs.

A ground-up rebuild of the capabilities of BluBloos/Pathtracer (a CPU
recursive-megakernel path tracer for Windows) as an SPMD wavefront renderer:

- recursion -> unrolled bounce loop with throughput accumulation over SoA
  ray batches (render/integrator.py);
- CPU thread pool over 32x32 tiles -> pixel sharding over a jax device mesh
  (parallel/);
- racy global Mersenne-Twister -> counter-based threefry streams keyed on
  (pixel, sample, bounce) (utils/prng.py);
- pointer octree -> flat uniform-grid CSR arrays traversed on device
  (scene/accel.py, ops/traverse.py);
- Win32 live viewer + BMP writer -> progressive accumulator checkpoints +
  byte-identical BMP output (render/, io/).
"""

__version__ = "0.1.0"

from .scene.schema import (  # noqa: F401
    MAX_BOUNCE_COUNT, Scene, WorldBuilder,
    WORLD_DEFAULT, WORLD_BRDF_TEST, WORLD_CORNELL_BOX,
    WORLD_RAYTRACING_ONE_WEEKEND, WORLD_MARIO,
    WORLD_CORNELL_QUAD, WORLD_MESH_UV,
)
from .scene.worlds import build_world, finalize_world  # noqa: F401
from .scene.camera import Camera, define_camera  # noqa: F401
from .render.renderer import RenderConfig, render_image  # noqa: F401
