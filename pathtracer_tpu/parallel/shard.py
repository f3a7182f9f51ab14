"""Multi-chip rendering: pixel sharding over a jax device mesh.

The reference distributes work as 32x32 pixel tiles handed to a CPU thread
pool by a master thread polling done-flags with memory barriers
(win32_main.cpp:829-987). Here the equivalent is data parallelism over the
pixel axis of a device mesh:

- pixels (flattened y-major) are sharded across the ``tiles`` mesh axis with
  ``shard_map``; every device runs the identical sample loop on its shard;
- because all randomness/geometry is a pure function of the linear pixel
  index (utils/prng.py, render/raygen.py), the sharded render is
  BIT-IDENTICAL to the single-chip render — no tile seams, no
  scheduler-dependent results (unlike the reference, whose shared-RNG race
  makes every run unique);
- scalar diagnostics (NaN count, rays cast) are combined with ``lax.psum``,
  which XLA lowers to an NCCL all-reduce between the cards (on one host
  they are joined all to all by NVLink, so the mesh is a plain 1-D list
  and its order does not matter); per-pixel accumulators stay
  device-resident between chunks, and the final gather to host happens
  once for BMP output.

There is no master/worker protocol to get wrong: the "scheduler" is XLA's
SPMD partitioner. The work is not perfectly regular, though: under path
regeneration a band of sky finishes before a band of geometry, so the
slowest card sets the frame time.
"""

from __future__ import annotations

import functools
import time as _time
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..scene.camera import Camera
from ..scene.schema import Scene
from ..utils import prng
from ..utils.vec import Vec3
from ..render.renderer import (
    AccumState, RenderConfig, finalize, init_accum, render_samples, resolve,
)


def make_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or the given) devices; axis ``tiles``."""
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), ("tiles",))


def _padded_pixels(n_pix: int, n_dev: int) -> int:
    return ((n_pix + n_dev - 1) // n_dev) * n_dev


@functools.partial(
    jax.jit,
    static_argnames=("camera", "config", "n_samples", "mesh"),
    donate_argnames=("state",),
)
def _render_chunk_sharded(
    scene: Scene, camera: Camera, config: RenderConfig, mesh: Mesh,
    key: jax.Array, s0: jnp.ndarray, n_samples: int,
    pixel_idx: jnp.ndarray, state: AccumState,
) -> AccumState:
    pix_spec = P("tiles")
    accum_spec = AccumState(
        sum=Vec3(pix_spec, pix_spec, pix_spec),
        sum_sq=Vec3(pix_spec, pix_spec, pix_spec),
        count=pix_spec,
        nan_count=P(),
        rays_cast=P(),
        samples_done=P(),
    )

    def shard_fn(scene, key, s0, pixel_shard, st):
        st = render_samples(scene, camera, config, key, s0, n_samples, st,
                            pixel_shard)
        # combine scalar diagnostics across the mesh (an NCCL all-reduce
        # on the GPU)
        return st._replace(
            nan_count=jax.lax.psum(st.nan_count, "tiles"),
            rays_cast=jax.lax.psum(st.rays_cast, "tiles"),
        )

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(), pix_spec, accum_spec),
        out_specs=accum_spec,
        # the integrator builds loop carries from literals (replicated), which
        # trips the varying-axes checker; the computation is per-shard pure
        check_vma=False,
    )
    return fn(scene, key, s0, pixel_idx, state)


def render_image_sharded(
    scene: Scene,
    camera: Camera,
    config: RenderConfig,
    mesh: Optional[Mesh] = None,
    chunk_samples: Optional[int] = None,
    state: Optional[AccumState] = None,
    progress_cb=None,
    adapt_chunk_s: Optional[float] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, AccumState]:
    """Sharded equivalent of render_image: same results, N-chip throughput.

    ``state`` may be a checkpoint from either renderer (exact-size, n_pix
    lanes) — it is padded to the mesh width and the render resumes at
    state.samples_done, exactly like render_image."""
    mesh = mesh or make_mesh()
    n_dev = mesh.devices.size
    n_pix = config.width * config.height
    n_pad = _padded_pixels(n_pix, n_dev)
    # padding lanes render duplicates of pixel 0 (cheap, dropped at resolve)
    pixel_idx = np.arange(n_pad, dtype=np.int32)
    pixel_idx[n_pix:] = 0
    pixel_idx = jnp.asarray(pixel_idx)

    key = prng.base_key(config.seed)
    if state is None:
        state = init_accum(n_pad)
    elif state.count.shape[0] == n_pix and n_pad != n_pix:
        pad = n_pad - n_pix
        zpad = lambda a: jnp.concatenate([a, jnp.zeros((pad,), a.dtype)])
        state = AccumState(
            sum=Vec3(zpad(state.sum.x), zpad(state.sum.y), zpad(state.sum.z)),
            sum_sq=Vec3(zpad(state.sum_sq.x), zpad(state.sum_sq.y),
                        zpad(state.sum_sq.z)),
            count=zpad(state.count),
            nan_count=state.nan_count,
            rays_cast=state.rays_cast,
            samples_done=state.samples_done,
        )
    total = config.spp
    chunk = min(chunk_samples or total, total)
    s0 = int(np.asarray(state.samples_done))
    first = True
    while s0 < total:
        n = min(chunk, total - s0)
        t0 = _time.perf_counter() if adapt_chunk_s else 0.0
        state = _render_chunk_sharded(scene, camera, config, mesh, key,
                                      jnp.asarray(s0, jnp.int32), n,
                                      pixel_idx, state)
        s0 += n
        if adapt_chunk_s and s0 < total:
            # --live cadence adaptation; see renderer.render_image
            jax.block_until_ready(state.rays_cast)
            dt = _time.perf_counter() - t0
            if first:
                first = False
            else:
                while chunk > 1 and dt > adapt_chunk_s * 1.5:
                    chunk //= 2
                    dt /= 2.0
        if progress_cb is not None:
            progress_cb(s0, total, state)

    trimmed = trim_accum(state, n_pix)
    img = resolve(trimmed, config)
    packed = finalize(trimmed, config)
    return img, packed, trimmed


def trim_accum(state: AccumState, n_pix: int) -> AccumState:
    """Drop the mesh-padding tail lanes (duplicates of pixel 0) so a
    mid-render sharded state can be previewed/finalized exactly like a
    single-chip one."""
    if state.count.shape[0] == n_pix:
        return state
    return AccumState(
        sum=Vec3(state.sum.x[:n_pix], state.sum.y[:n_pix], state.sum.z[:n_pix]),
        sum_sq=Vec3(state.sum_sq.x[:n_pix], state.sum_sq.y[:n_pix],
                    state.sum_sq.z[:n_pix]),
        count=state.count[:n_pix],
        nan_count=state.nan_count,
        rays_cast=state.rays_cast,
        samples_done=state.samples_done,
    )
