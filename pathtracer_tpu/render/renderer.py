"""Renderer: sample accumulation, tonemap, packing — the RenderTexel role.

The reference averages g_pp^2 radiance samples per pixel (contrib = 1/pp^2,
win32_main.cpp:1040-1074), resampling NaN radiance (:1068), then applies
ACES tonemap -> sRGB -> x255 -> BGRA pack (:1172-1182). This renderer:

- renders whole-image wavefronts, one stratified sample for every pixel per
  step (sample-space and image-space parallelism are both batch axes);
- accumulates a (sum, sum_sq, valid_count) state, masking NaN samples
  instead of resampling (unbiased; NaN lanes are also counted for
  observability);
- the accumulator state IS the checkpoint (see progressive.py): a render
  can stop/resume at any chunk boundary.

Debug render kinds mirror debug_render_kind_t (win32_main.cpp:22-28): only
``regular`` gets the tonemap (win32_main.cpp:1172-1173); ``variance``
renders per-pixel sample variance (:1016-1082).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..scene.camera import Camera
from ..scene.schema import Scene
from ..utils import prng
from ..utils.color import bgra_pack, tonemap_aces
from ..utils.vec import Vec3, to_stacked
from . import raygen
from .integrator import REGULAR, VARIANCE, DEBUG_KINDS, trace


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 1280
    height: int = 720
    pp: int = 4                  # sqrt(rays per pixel), g_pp (win32_main.cpp:2112)
    seed: int = 0
    debug_kind: str = REGULAR
    just_importance: bool = False
    # Russian roulette (reference TODO win32_main.cpp:187; north star
    # requires it). Off by default to match the reference estimator.
    use_russian_roulette: bool = False
    # "auto": path-regeneration wavefront for regular/variance (fastest),
    # unrolled bounce loop otherwise. "unrolled" forces the unrolled
    # driver for regular/variance too (the equivalence tests compare the
    # two); debug kinds always run unrolled.
    mode: str = "auto"
    # Linear exposure multiplier applied before the tonemap. The reference
    # lists exposure as unrealized camera work (win32_main.cpp:180-181);
    # 1.0 = exact reference behavior.
    exposure: float = 1.0
    # Opt-in mip-mapped texture sampling (--mips): world-units-per-pixel at
    # unit distance (film_height / (image_height * focal_length)); 0.0 =
    # mip 0 only, the reference-parity default (win32_main.cpp:620,630,639
    # always read mips[0]; the chain itself was the reference's unfinished
    # TODO). See integrator.shade_bounce for the LOD rule.
    mip_scale: float = 0.0
    # Opt-in a-trous denoiser iterations applied to the linear image before
    # the tonemap (--denoise; the reference's "denoising" TODO,
    # win32_main.cpp:184). 0 = raw estimator (golden-test parity).
    denoise: int = 0

    @property
    def spp(self) -> int:
        return self.pp * self.pp

    def resolved_mode(self) -> str:
        if self.debug_kind not in (REGULAR, VARIANCE):
            return "unrolled"
        return "unrolled" if self.mode == "unrolled" else "wavefront"


class AccumState(NamedTuple):
    """Progressive accumulator (the natural checkpoint state, SURVEY.md §5)."""
    sum: Vec3            # per-pixel radiance sum over valid samples
    sum_sq: Vec3         # per-pixel sum of squares (for the variance target)
    count: jnp.ndarray   # per-pixel valid (non-NaN) sample count
    nan_count: jnp.ndarray  # scalar: NaN samples masked (observability)
    rays_cast: jnp.ndarray  # scalar: total rays traced
    samples_done: jnp.ndarray  # scalar: whole-image samples completed (resume)


def init_accum(n_pixels: int) -> AccumState:
    z = lambda: jnp.zeros((n_pixels,), jnp.float32)
    return AccumState(
        sum=Vec3(z(), z(), z()),
        sum_sq=Vec3(z(), z(), z()),
        count=z(),
        nan_count=jnp.zeros((), jnp.float32),
        rays_cast=jnp.zeros((), jnp.float32),
        samples_done=jnp.zeros((), jnp.int32),
    )


def _one_sample(scene: Scene, camera: Camera, config: RenderConfig,
                key: jax.Array, s: jnp.ndarray, state: AccumState,
                pixel_idx: Optional[jnp.ndarray] = None) -> AccumState:
    """Trace sample index ``s`` for the given pixels (default: all) and fold
    into the accumulator. ``pixel_idx`` support is what makes the same code
    path serve single-chip, sharded multi-chip, and tiled rendering — all
    randomness/geometry is a pure function of the linear pixel index."""
    if pixel_idx is None:
        pixel_idx = jnp.arange(config.width * config.height, dtype=jnp.int32)

    if camera.use_pinhole:
        i, j = s // config.pp, s % config.pp
        pkeys = prng.path_keys(key, pixel_idx, s)
        jitter = prng.jitter_uniforms_v(pkeys)
        o, d = raygen.pinhole_rays(camera, config.width, config.height,
                                   config.pp, i, j, jitter, pixel_idx)
    else:
        ray_index, ray_index2 = s // config.pp, s % config.pp
        # lens offsets are keyed per (pixel, rayIndex): the inner Poisson loop
        # shares the sensor point (win32_main.cpp:1114-1125)
        lens_keys = prng.path_keys(key, pixel_idx, ray_index)
        lens_u = prng.lens_uniforms_v(lens_keys)
        pkeys = prng.path_keys(key, pixel_idx, s)
        o, d = raygen.thin_lens_rays(camera, config.width, config.height,
                                     config.pp, ray_index, ray_index2, lens_u,
                                     pixel_idx)

    radiance, stats = trace(scene, o, d, pkeys,
                            debug_kind=config.debug_kind,
                            just_importance=config.just_importance,
                            use_russian_roulette=config.use_russian_roulette,
                            mip_scale=config.mip_scale)

    # NaN policy: mask & count (the reference resamples, win32_main.cpp:1068)
    bad = jnp.isnan(radiance.x) | jnp.isnan(radiance.y) | jnp.isnan(radiance.z)
    ok = ~bad
    okf = ok.astype(jnp.float32)
    rx = jnp.where(ok, radiance.x, 0.0)
    ry = jnp.where(ok, radiance.y, 0.0)
    rz = jnp.where(ok, radiance.z, 0.0)

    return AccumState(
        sum=Vec3(state.sum.x + rx, state.sum.y + ry, state.sum.z + rz),
        sum_sq=Vec3(state.sum_sq.x + rx * rx, state.sum_sq.y + ry * ry,
                    state.sum_sq.z + rz * rz),
        count=state.count + okf,
        nan_count=state.nan_count + jnp.sum(bad.astype(jnp.float32)),
        rays_cast=state.rays_cast + stats.rays_cast,
        samples_done=state.samples_done + 1,
    )


@functools.partial(jax.jit, static_argnames=("camera", "config", "n_samples"),
                   donate_argnames=("state",))
def render_chunk(scene: Scene, camera: Camera, config: RenderConfig,
                 key: jax.Array, s0: jnp.ndarray, n_samples: int,
                 state: AccumState) -> AccumState:
    """Accumulate ``n_samples`` consecutive sample indices starting at s0.
    Jitted once per (scene shapes, camera, config, n_samples); the sample
    loop runs on-device, no host round-trips. Dispatches to the
    path-regeneration wavefront driver when the config allows (bit-identical
    results, ~2.5x fewer lane-bounces on early-terminating scenes)."""
    pixel_idx = jnp.arange(config.width * config.height, dtype=jnp.int32)
    return render_samples(scene, camera, config, key, s0, n_samples, state,
                          pixel_idx)


def render_samples(scene: Scene, camera: Camera, config: RenderConfig,
                   key: jax.Array, s0: jnp.ndarray, n_samples: int,
                   state: AccumState, pixel_idx: jnp.ndarray) -> AccumState:
    """The sample loop over the given pixels, shared by the single-device
    and sharded renderers: the path-regeneration wavefront driver for
    regular/variance renders, the unrolled bounce loop for debug kinds."""
    if config.resolved_mode() == "wavefront":
        from .wavefront import render_chunk_wavefront
        return render_chunk_wavefront(scene, camera, config, key, s0,
                                      n_samples, state, pixel_idx)

    def body(k, st):
        return _one_sample(scene, camera, config, key, s0 + k, st, pixel_idx)
    return jax.lax.fori_loop(0, n_samples, body, state)


def _pixel_value(state: AccumState, config: RenderConfig) -> Vec3:
    """Per-pixel value from the accumulator: mean radiance, or the biased
    per-sample variance for the variance target (win32_main.cpp:1076-1082)."""
    cnt = jnp.maximum(state.count, 1.0)
    mean = Vec3(state.sum.x / cnt, state.sum.y / cnt, state.sum.z / cnt)
    if config.debug_kind == VARIANCE:
        mean = Vec3(
            state.sum_sq.x / cnt - mean.x * mean.x,
            state.sum_sq.y / cnt - mean.y * mean.y,
            state.sum_sq.z / cnt - mean.z * mean.z,
        )
    return mean


def resolve(state: AccumState, config: RenderConfig) -> jnp.ndarray:
    """Accumulator -> (H, W, 3) float32 (linear, pre-tonemap)."""
    img = to_stacked(_pixel_value(state, config))
    return img.reshape(config.height, config.width, 3)


def finalize(state: AccumState, config: RenderConfig) -> jnp.ndarray:
    """Accumulator -> packed BGRA uint32 (H, W) framebuffer bytes, matching
    the reference's pixel pipeline (win32_main.cpp:1172-1182; tonemap only
    for the regular target, :1172-1173). With config.denoise > 0 the
    linear image runs the variance-guided a-trous filter first
    (render/denoise.py — the reference's "denoising" TODO)."""
    mean = _pixel_value(state, config)
    if config.debug_kind == REGULAR:
        if config.denoise > 0:
            from .denoise import accum_variance, atrous_denoise
            img = to_stacked(mean).reshape(config.height, config.width, 3)
            img = atrous_denoise(img, accum_variance(state, config),
                                 iterations=config.denoise)
            flat = img.reshape(-1, 3)
            mean = Vec3(flat[:, 0], flat[:, 1], flat[:, 2])
        if config.exposure != 1.0:
            mean = mean * config.exposure
        mean = tonemap_aces(mean)
    packed = bgra_pack(mean)
    return packed.reshape(config.height, config.width)


def render_image(
    scene: Scene,
    camera: Camera,
    config: RenderConfig,
    chunk_samples: Optional[int] = None,
    state: Optional[AccumState] = None,
    progress_cb=None,
    adapt_chunk_s: Optional[float] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, AccumState]:
    """Full render: returns (mean_radiance (H,W,3), packed_bgra (H,W), state).

    ``chunk_samples`` bounds the samples per jit invocation (progressive
    preview / checkpoint cadence); defaults to all of them in one call.

    ``adapt_chunk_s`` (the --live cadence, VERDICT r4 item 9): target
    seconds between progress callbacks. Slow worlds run a 64-sample chunk
    for tens of seconds — far coarser than the reference viewer's
    every-loop blit (win32_main.cpp:252-274). When a steady-state chunk
    overshoots the target, the chunk HALVES (power-of-two sizes bound the
    extra jit signatures to log2(chunk)); the first chunk's timing is
    ignored (compile-tainted). No cost when unset, and no effect on
    results either way (chunking is exact — same samples, same sums)."""
    assert config.debug_kind in DEBUG_KINDS
    total = config.spp
    chunk = min(chunk_samples or total, total)
    key = prng.base_key(config.seed)
    if state is None:
        state = init_accum(config.width * config.height)
    # exact resume: the accumulator records how many whole-image samples are
    # already folded in; the counter-based PRNG regenerates the rest verbatim
    s0 = int(np.asarray(state.samples_done))
    first = True
    while s0 < total:
        n = min(chunk, total - s0)
        t0 = time.perf_counter() if adapt_chunk_s else 0.0
        state = render_chunk(scene, camera, config, key,
                             jnp.asarray(s0, jnp.int32), n, state)
        s0 += n
        if adapt_chunk_s and s0 < total:
            jax.block_until_ready(state.rays_cast)
            dt = time.perf_counter() - t0
            if first:
                first = False  # compile-tainted timing
            else:
                while chunk > 1 and dt > adapt_chunk_s * 1.5:
                    chunk //= 2
                    dt /= 2.0
        if progress_cb is not None:
            progress_cb(s0, total, state)
    img = resolve(state, config)
    packed = finalize(state, config)
    return img, packed, state
