"""Command-line application — the win32_main `main`/ParseArgs role.

Mirrors the reference CLI exactly (PrintHelp win32_main.cpp:2076-2104,
ParseArgs :2110-2195): single-dash concatenated flags, same letters, same
clamps (p <= 1000 = RAYS_PER_PIXEL_MAX, w in [1,5]); `-t` (thread count) is
accepted for compatibility and reported as the device count actually used —
the scheduler is the XLA SPMD partitioner, not a thread pool.

Extensions beyond the reference (all default-off):
  --size WxH         image size (reference hardcodes 1280x720, :218-219)
  --out PATH         output path (reference hardcodes test.bmp, :984)
  --png PATH         also write a PNG
  --debug MODE       runtime debug render kinds (the reference compiles them
                     in, :22-28): regular | primary_ray_normals |
                     bounce_count | termination_condition | variance
  --seed N           RNG seed (the reference seeds from the OS)
  --checkpoint PATH  save/resume the progressive accumulator
  --chunk N          samples per device dispatch (progress cadence)
  --profile DIR      capture a JAX profiler trace
  --single-chip      disable pixel sharding over the device mesh

Run: python -m pathtracer_tpu [options]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def _parse_reference_flags(argv):
    """Parse the reference's concatenated single-dash flags (-t16 -p16 -nmr)
    into (known dict, remaining argv for argparse)."""
    out = {"t": None, "p": None, "w": None, "d": False,
           "n": False, "m": False, "r": False, "h": False}
    rest = []
    for arg in argv:
        if arg.startswith("--") or not arg.startswith("-") or arg == "-":
            rest.append(arg)
            continue
        body = arg[1:]
        i = 0
        while i < len(body):
            c = body[i]
            if c in "tpw":
                j = i + 1
                while j < len(body) and (body[j].isdigit() or body[j] == "-"):
                    j += 1
                val = body[i + 1: j]
                out[c] = int(val) if val else 0
                i = j
            elif c in "dnmrh":
                out[c] = True
                i += 1
            else:
                print(f"Warning: invalid program arugment -{c}")  # sic, :2188
                i += 1
    return out, rest


def print_help():
    """PrintHelp (win32_main.cpp:2076-2104) plus this port's extensions."""
    print("usage: python -m pathtracer_tpu [options]\n")
    print("Physically-based path tracer capable of rendering various "
          "geometrical shapes, including triangles.")
    print("JAX/XLA rebuild of BluBloos/Pathtracer for NVIDIA GPUs.\n")
    print("optional arguments:")
    print("\tt<int>  - Set the number of threads to use. (compat: reported as devices)")
    print("\tp<int>  - Set the rays to shoot per pixel (sqrt; total = p*p).")
    print("\tw<int>  - Set the world number to load. Possible options:")
    print("\t\t1:\tDefault scene.\n\t\t2:\tMetal-roughness test.\n"
          "\t\t3:\tCornell box.\n\t\t4:\tRay Tracing in One Weekend book cover.\n"
          "\t\t5:\tMario N64 model.\n"
          "\t\t6:\tCornell box with a quad AREA light (extension;\n"
          "\t\t\texercises the reference's unused PdfValueQuad).\n"
          "\t\t7:\tUV-textured sphere mesh (extension; the\n"
          "\t\t\ttextured-materials TODO as a benchable scene).")
    print("\td       - Enable depth of field via thin-lens approximation.")
    print("\tn       - Disable loading normal map textures.")
    print("\tm       - Disable loading metalness material textures.")
    print("\tr       - Disable loading roughness material textures.")
    print("\th       - Print this help menu.")
    print("\nExtensions: --size WxH --out PATH --png PATH --debug MODE "
          "--seed N --checkpoint PATH --chunk N --profile DIR --single-chip "
          "--rr --mode auto|unrolled|wavefront --preview PATH --live "
          "--probe-pixel X,Y --exposure F --mips --flip x|y|xy")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    ref, rest = _parse_reference_flags(argv)
    if ref["h"]:
        print_help()
        return 0

    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--size", default="1280x720")
    ap.add_argument("--out", default="test.bmp")
    ap.add_argument("--png", default=None)
    ap.add_argument("--debug", default="regular")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--chunk", type=int, default=None,
                    help="samples per device dispatch (default: min(spp, 64); "
                         "single long dispatches can trip runtime watchdogs)")
    ap.add_argument("--profile", default=None)
    ap.add_argument("--single-chip", action="store_true")
    ap.add_argument("--rr", action="store_true",
                    help="Russian-roulette path termination (unbiased)")
    ap.add_argument("--mode", default="auto",
                    choices=["auto", "unrolled", "wavefront"])
    ap.add_argument("--preview", default=None,
                    help="write a progressive preview PNG at each --chunk "
                         "boundary (the live-viewer role, win32_main.cpp:252-274)")
    ap.add_argument("--live", action="store_true",
                    help="draw the progressive image in the terminal each "
                         "chunk (ANSI half-block; the blit-loop role)")
    ap.add_argument("--exposure", type=float, default=1.0,
                    help="linear exposure multiplier before the tonemap "
                         "(the reference's unrealized camera TODO)")
    ap.add_argument("--probe-pixel", default=None, metavar="X,Y",
                    help="print mean/variance radiance of one pixel "
                         "(the DEBUG_MIDDLE_PIXEL role, win32_main.cpp:18,1011-1014)")
    ap.add_argument("--mips", action="store_true",
                    help="mip-mapped texture sampling (the reference's "
                         "unfinished GenerateMipmapChain TODO, "
                         "win32_main.cpp:2307-2328); off = mip-0-only "
                         "reference parity")
    ap.add_argument("--flip", default="", choices=["", "x", "y", "xy"],
                    help="flip the saved image along X, Y, or both (the "
                         "reference's granular save-orientation TODO, "
                         "win32_main.cpp:142-144)")
    ap.add_argument("--fog", type=float, default=0.0, metavar="SIGMA_T",
                    help="global homogeneous fog extinction coefficient "
                         "(volumetric light transport — the reference's "
                         "'god rays and fog' TODO, win32_main.cpp:159)")
    ap.add_argument("--fog-albedo", default="1,1,1", metavar="R,G,B",
                    help="fog single-scatter albedo per channel")
    ap.add_argument("--fog-g", type=float, default=0.0,
                    help="Henyey-Greenstein anisotropy in (-1,1); "
                         "0 = isotropic, >0 forward-scattering")
    ap.add_argument("--denoise", type=int, default=0, metavar="N",
                    help="a-trous denoiser iterations on the linear image "
                         "before the tonemap (the reference's 'denoising' "
                         "TODO, win32_main.cpp:184); 0 = raw estimator")
    ap.add_argument("--tbn", action="store_true",
                    help="rotate normal maps into the surface tangent "
                         "frame (the reference's non-up-surface normal-map "
                         "TODO, win32_main.cpp:175); off = world-space "
                         "replacement parity (:642)")
    ap.add_argument("--scene-seed", default=None, metavar="N|os",
                    help="seed for world 4's random RTIOW layout "
                         "(win32_main.cpp:1966 seeds MT from the OS so the "
                         "reference scene differs per run; our default is "
                         "the fixed seed 1337 for reproducibility — pass an "
                         "integer for a specific layout or 'os' for the "
                         "reference's per-run-random semantics)")
    args = ap.parse_args(rest)

    import jax
    from .device import device_record, setup_compile_cache
    from .render.renderer import RenderConfig, render_image
    from .parallel.shard import make_mesh, render_image_sharded
    from .scene.worlds import finalize_world
    from .scene.schema import WORLD_KIND_COUNT
    from .io.bmp import packed_to_rgb, write_bmp
    from .utils.profiling import PhaseTimer, RenderMetrics, profiler_trace

    w, h = (int(x) for x in args.size.split("x"))
    pp = max(0, min(1000, ref["p"])) if ref["p"] is not None else 4  # :2171, RAYS_PER_PIXEL_MAX
    world = max(0, min(WORLD_KIND_COUNT - 1, (ref["w"] or 1) - 1))   # :2181
    use_pinhole = not ref["d"]                                        # :2183

    setup_compile_cache()
    devices = jax.devices()
    n_dev = len(devices)
    if ref["t"] is not None:
        n_dev = max(1, min(ref["t"], n_dev))
        devices = devices[:n_dev]
    print(f"System has {len(jax.devices())} device(s).")   # cf. :2193
    print(f"Using {n_dev} device(s).")                     # cf. :2194
    rec = device_record()
    print(f"Platform {rec['platform']}, {rec['kind']}.\n")

    rtiow_seed = 1337
    if args.scene_seed is not None:
        if args.scene_seed == "os":
            import secrets
            rtiow_seed = secrets.randbits(31)  # the reference's OS-seeded MT
            print(f"(--scene-seed os: layout seed {rtiow_seed})")
        else:
            rtiow_seed = int(args.scene_seed)

    timer = PhaseTimer()
    with timer.phase("scene"):
        scene, camera = finalize_world(
            world, w, h,
            use_pinhole=use_pinhole,
            use_normal_maps=not ref["n"],
            use_metalness_maps=not ref["m"],
            use_roughness_maps=not ref["r"],
            rtiow_seed=rtiow_seed,
        )
        if args.tbn:
            scene = scene.replace(tbn_normal_maps=True)
        if args.fog > 0.0:
            try:
                fog_albedo = tuple(float(v)
                                   for v in args.fog_albedo.split(","))
            except ValueError:
                fog_albedo = ()
            if len(fog_albedo) != 3:
                raise SystemExit("--fog-albedo needs R,G,B "
                                 "(three comma-separated numbers)")
            scene = scene.replace(
                fog_sigma_t=float(args.fog),
                fog_albedo=fog_albedo,
                fog_g=float(args.fog_g),
            )

    # camera diagnostics block (win32_main.cpp:2234-2248)
    print("DefineCamera():\n===")
    print(f"camera located at c->pos = ({camera.pos[0]:f},{camera.pos[1]:f},{camera.pos[2]:f})")
    print(f"Distance between the lens and the film plane: {camera.focal_length:f}")
    for name in ("axis_x", "axis_y", "axis_z"):
        v = getattr(camera, name)
        print(f"c->{name.replace('_', '')}: ({v[0]:f},{v[1]:f},{v[2]:f})")
    print(
        "The film plane is embedded in the plane defined by c->axisX and c->axisY.\n"
        "Rays are shot originating at the lens located at c->pos and \"strike a "
        "sensor on the film to develop the image\".\n"
        "The camera has a local coordinate system which is different from the "
        "world coordinate system.\n"
        "The camera is looking down the negative c->axisZ direction.\n")

    mip_scale = 0.0
    if args.mips:
        if scene.tex_mip_meta:
            # texels-per-pixel at unit distance: film pixel size over the
            # lens-film distance (the bespoke w/2 texel density is folded
            # in by integrator.shade_bounce's k constant)
            mip_scale = (2.0 * camera.half_film_height
                         / (h * camera.focal_length))
        else:
            print("(--mips: scene has no square pow2 combined texture set; "
                  "mip-0 sampling.)")

    cfg = RenderConfig(width=w, height=h, pp=pp, seed=args.seed,
                       debug_kind=args.debug,
                       use_russian_roulette=args.rr, mode=args.mode,
                       exposure=args.exposure, mip_scale=mip_scale,
                       denoise=args.denoise)
    if args.chunk is None:
        args.chunk = min(cfg.spp, 64)

    state = None
    if args.checkpoint:
        from .render.progressive import load_checkpoint
        state, done = load_checkpoint(args.checkpoint, w * h)
        if done:
            print(f"Resuming from {args.checkpoint}: "
                  f"{float(np.asarray(state.count).max()):.0f} samples done.")

    live = None
    if args.live:
        from .io.term import LiveView, supports_color
        if supports_color():
            live = LiveView()
        else:
            print("(--live: stdout is not a color terminal; disabled)")

    def progress(s_done, s_total, st):
        if s_total > args.chunk and live is None:
            print(f"  {s_done}/{s_total} samples "
                  f"({float(np.asarray(st.rays_cast)) / 1e6:.1f} Mrays)")
        if args.checkpoint:
            from .render.progressive import save_checkpoint
            save_checkpoint(args.checkpoint, st)
        if args.preview or live is not None:
            # the sharded path carries mesh-padding lanes mid-render; trim
            # before finalizing (parallel/shard.trim_accum)
            from .parallel.shard import trim_accum
            from .render.renderer import finalize as _finalize
            pk = np.asarray(_finalize(trim_accum(st, w * h), cfg))
            rgb = packed_to_rgb(pk)[::-1]
            if args.preview:
                from PIL import Image
                Image.fromarray(rgb).save(args.preview)
            if live is not None:
                live.update(rgb, status=f"  {s_done}/{s_total} samples")

    # --live cadence: adapt the chunk size toward ~2 s between frame
    # updates (the reference viewer blits continuously,
    # win32_main.cpp:252-274; a slow world's 64-sample chunk can run tens
    # of seconds). Exact chunking — results are unchanged.
    adapt = 2.0 if live is not None else None

    with timer.phase("render"), profiler_trace(args.profile):
        t0 = time.perf_counter()
        if args.single_chip or n_dev == 1:
            img, packed, state = render_image(scene, camera, cfg,
                                              chunk_samples=args.chunk,
                                              state=state,
                                              progress_cb=progress,
                                              adapt_chunk_s=adapt)
        else:
            mesh = make_mesh(devices)
            img, packed, state = render_image_sharded(
                scene, camera, cfg, mesh=mesh, chunk_samples=args.chunk,
                state=state, progress_cb=progress, adapt_chunk_s=adapt)
        packed = np.asarray(jax.block_until_ready(packed))
        wall = time.perf_counter() - t0

    with timer.phase("write"):
        # --out dispatches on the file extension (the reference's own TODO
        # "output image filepath; dynamically find extension and output
        # based on that", win32_main.cpp:146): .bmp keeps the byte-exact
        # reference DIB writer; anything PIL can encode (.png .jpg .tga
        # .gif ...) goes through PIL — the stb_image_write role.
        pk = packed
        if "x" in args.flip:
            pk = pk[:, ::-1]
        if "y" in args.flip:
            pk = pk[::-1]
        # splitext (not rsplit on the whole path) so a dotted DIRECTORY
        # ("results.v2/render") reads as extensionless
        ext = os.path.splitext(args.out)[1].lower().lstrip(".")
        if ext in ("bmp", ""):
            write_bmp(args.out, pk)
        else:
            try:
                from PIL import Image
                Image.fromarray(packed_to_rgb(pk)[::-1]).save(args.out)
            except ValueError:
                # unknown extension must not lose a finished render:
                # fall back to the reference BMP bytes at the same path
                print(f"(--out: unknown extension .{ext}; "
                      "writing BMP bytes)")
                write_bmp(args.out, pk)
        if args.png:
            from PIL import Image
            Image.fromarray(packed_to_rgb(pk)[::-1]).save(args.png)

    if args.probe_pixel:
        px, py = (int(v) for v in args.probe_pixel.split(","))
        lin = py * w + px
        cnt = max(float(np.asarray(state.count[lin])), 1.0)
        mean = [float(np.asarray(c[lin])) / cnt for c in
                (state.sum.x, state.sum.y, state.sum.z)]
        var = [float(np.asarray(sq[lin])) / cnt - m * m for sq, m in
               zip((state.sum_sq.x, state.sum_sq.y, state.sum_sq.z), mean)]
        print(f"probe pixel ({px},{py}): mean radiance = "
              f"({mean[0]:f},{mean[1]:f},{mean[2]:f})  variance = "
              f"({var[0]:f},{var[1]:f},{var[2]:f})  samples = {cnt:.0f}")

    m = RenderMetrics(rays_cast=float(np.asarray(state.rays_cast)),
                      wall_seconds=wall, width=w, height=h, spp=pp * pp,
                      nan_samples=float(np.asarray(state.nan_count)))
    print(f"Done. Image written to {args.out}.")  # cf. :985
    print(f"[perf] {m.mrays_per_sec:.1f} Mrays/s  "
          f"({m.rays_cast / 1e6:.1f} Mrays in {wall:.2f}s; "
          f"{m.nan_samples:.0f} NaN samples masked)  {timer.report()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
