"""Benchmark: Mrays/sec of the renderer on one NVIDIA GPU.

Workload: 1280x720 by default. Measures steady-state ray throughput of the
full pipeline (raygen -> intersect -> shade -> accumulate) after a warm-up
that compiles every shape the timed loop uses, then prints ONE JSON line:

    {"metric": "Mrays/sec", "value": N, "unit": "Mrays/s",
     "device": {"platform": "gpu", "kind": ..., "count": ...},
     "gpu": "<nvidia-smi name, power.limit>",
     "aggregate": {"geomean_mrays": G, "spp": 64, "worlds": {...}}}

The headline "value" is Cornell (world 3); the aggregate block runs every
world at 64 spp and reports their geomean. World 5 is reported
"unavailable" when its mesh asset is absent, and the geomean then covers
the rest (``complete`` says so). `--world K` benches one world at the full
1024-spp workload. Times are host-clock walls around work that ends in
``block_until_ready``; the best of ``repeats`` runs is reported.

No GPU, no number: without one the script prints an error naming the
platform JAX found and exits 1.

Flags: --spp N, --full (1024 spp), --world K, --size WxH, --sharded (all
devices), --rr, --mips, --rmse (fidelity gate against the scalar CPU
oracle on Cornell's full 720p frame).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def device_fields() -> dict:
    """The device record and the card's nvidia-smi name and power limit,
    carried by every result line."""
    from pathtracer_tpu import device
    smi = device.nvidia_smi()
    return {"device": device.device_record(),
            "gpu": smi[0] if smi else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=None,
                    help="measured samples per pixel (default: 1024 for "
                         "--world K; 64 for the all-world aggregate block)")
    ap.add_argument("--full", action="store_true",
                    help="run the full 1024-spp workload")
    ap.add_argument("--world", type=int, default=None,
                    help="1-based world number; without it, bench runs the "
                         "Cornell headline PLUS a per-world block over all "
                         "worlds and reports their geomean")
    ap.add_argument("--size", default="1280x720", help="WxH")
    ap.add_argument("--sharded", action="store_true",
                    help="shard over all devices (default: one device)")
    ap.add_argument("--rmse", action="store_true",
                    help="gate the device render against the scalar CPU "
                         "oracle at Cornell 1280x720 (RMSE < 1e-3, "
                         "BASELINE.json) and print one JSON line. Uses the "
                         "committed oracle frame "
                         "(images/oracle_cornell_720p_1spp.npz); "
                         "--regen-oracle recomputes it (tens of minutes of "
                         "scalar numpy)")
    ap.add_argument("--regen-oracle", action="store_true",
                    help="with --rmse: recompute the 720p oracle frame "
                         "instead of reading the cache")
    ap.add_argument("--rr", action="store_true",
                    help="bench with Russian roulette enabled")
    ap.add_argument("--mips", action="store_true",
                    help="bench with mip-mapped texture sampling")
    args = ap.parse_args(argv)

    from pathtracer_tpu import device
    try:
        device.require_gpu()
    except device.NoGPUError as e:
        print(json.dumps({"metric": "Mrays/sec", "error": str(e)}))
        return 1
    device.setup_compile_cache()
    fields = device_fields()

    if args.rmse:
        result = rmse_vs_oracle(regen=args.regen_oracle)
        print(json.dumps({**result, **fields}))
        return 0 if result.get("ok") else 1

    if args.world is not None:
        spp = 1024 if args.full else (args.spp or 1024)
        mrays = bench_world(args.world, spp, args.size, rr=args.rr,
                            mips=args.mips, sharded=args.sharded)
        print(json.dumps({
            "metric": "Mrays/sec", "value": mrays, "unit": "Mrays/s",
            "world": args.world, "spp": spp, "size": args.size, **fields,
        }))
        return 0

    headline_spp = 1024 if args.full else (args.spp or 256)
    block_spp = 1024 if args.full else (args.spp or 64)
    headline = bench_world(3, headline_spp, args.size, rr=args.rr,
                           sharded=args.sharded, repeats=2)
    worlds = {}
    for wld in (1, 2, 3, 4, 5, 6, 7):
        try:
            worlds[str(wld)] = bench_world(
                wld, block_spp, args.size, rr=args.rr, mips=args.mips,
                sharded=args.sharded, repeats=2)
        except MeshAbsent:
            worlds[str(wld)] = "unavailable: mesh asset absent"
        except Exception as e:  # noqa: BLE001 — record, keep benching
            worlds[str(wld)] = {"error": f"{type(e).__name__}: {e}"[:200]}
    vals = [v for v in worlds.values() if isinstance(v, float)]
    errors = [v for v in worlds.values() if isinstance(v, dict)]
    geomean = (float(np.exp(np.mean(np.log(vals))))
               if vals and not errors else None)
    print(json.dumps({
        "metric": "Mrays/sec", "value": headline, "unit": "Mrays/s",
        **fields,
        "aggregate": {
            "geomean_mrays": geomean,
            "complete": len(vals) == len(worlds),
            "spp": block_spp, "size": args.size, "rr": args.rr,
            "mips": args.mips, "worlds": worlds,
        },
    }))
    return 0 if not errors else 1


class MeshAbsent(RuntimeError):
    """World 5's mesh asset is not in the checkout."""


def bench_world(world: int, spp: int, size: str, rr: bool = False,
                mips: bool = False, sharded: bool = False,
                repeats: int = 1) -> float:
    """One world's steady-state Mrays/s: the best of ``repeats`` timed
    runs of the same compiled executable, each synced with
    ``block_until_ready``."""
    import jax
    from pathtracer_tpu.render.renderer import (
        RenderConfig, init_accum, render_chunk,
    )
    from pathtracer_tpu.scene.schema import WORLD_MARIO
    from pathtracer_tpu.scene.worlds import finalize_world
    from pathtracer_tpu.utils import prng

    w, h = (int(x) for x in size.split("x"))
    scene, camera = finalize_world(world - 1, w, h)
    if world - 1 == WORLD_MARIO and scene.n_tris == 0:
        raise MeshAbsent()

    pp = int(round(spp ** 0.5))
    mip_scale = 0.0
    if mips and scene.tex_mip_meta:
        mip_scale = (2.0 * camera.half_film_height
                     / (h * camera.focal_length))
    config = RenderConfig(width=w, height=h, pp=pp, seed=0,
                          use_russian_roulette=rr, mip_scale=mip_scale)
    key = prng.base_key(0)

    if sharded and len(jax.devices()) > 1:
        from pathtracer_tpu.parallel.shard import render_image_sharded
        jax.block_until_ready(render_image_sharded(scene, camera, config)[1])
        best = 0.0
        for _ in range(max(1, repeats)):
            t0 = time.perf_counter()
            _, packed, state = render_image_sharded(scene, camera, config)
            jax.block_until_ready((packed, state))
            wall = time.perf_counter() - t0
            best = max(best, float(state.rays_cast) / wall)
        return best / 1e6

    # Equal chunks of at most 256 samples: one jit signature, so the
    # warm-up compiles everything the timed loop runs.
    n_div = -(-config.spp // 256)
    n_meas = -(-config.spp // n_div)
    jax.block_until_ready(render_chunk(scene, camera, config, key,
                                       np.int32(0), n_meas,
                                       init_accum(w * h)))
    best = 0.0
    for _ in range(max(1, repeats)):
        state = init_accum(w * h)
        jax.block_until_ready(state)
        t0 = time.perf_counter()
        s0 = 0
        while s0 < config.spp:
            n = min(n_meas, config.spp - s0)
            state = render_chunk(scene, camera, config, key, np.int32(s0), n,
                                 state)
            s0 += n
        jax.block_until_ready(state)
        wall = time.perf_counter() - t0
        best = max(best, float(state.rays_cast) / wall)
    return best / 1e6


ORACLE_CACHE = "images/oracle_cornell_720p_1spp.npz"


def rmse_vs_oracle(regen: bool = False) -> dict:
    """Fidelity gate: render Cornell at 1280x720 and 1 spp on the device
    and compare with the independent scalar CPU oracle.

    The oracle and renderer consume identical PCG4D streams, so they agree
    per SAMPLE to f32 rounding; the error field is sparse discrete flips
    (an ulp difference resolves a coin or a boundary to a different but
    legitimate sample) plus rounding noise. Per-sample errors at different
    sample indices are independent draws of the same class, so the RMSE
    of a 1024-spp mean is rmse_1spp / sqrt(1024). The gate holds that, the
    median |diff| (the non-flip mass) and the flip rate. The oracle frame
    is rendered once and cached (``--regen-oracle``); the device side
    renders fresh every run."""
    import os
    from pathtracer_tpu import RenderConfig, finalize_world, render_image
    from pathtracer_tpu.scene.schema import WORLD_CORNELL_BOX
    from pathtracer_tpu.scene.worlds import build_world

    w, h, pp, seed = 1280, 720, 1, 0
    scene, cam = finalize_world(WORLD_CORNELL_BOX, w, h)

    if regen or not os.path.exists(ORACLE_CACHE):
        from pathtracer_tpu.reference.cpu_oracle import render_oracle
        b, _ = build_world(WORLD_CORNELL_BOX)
        t0 = time.perf_counter()
        oracle = render_oracle(b, cam, w, h, pp, seed=seed,
                               world_kind=WORLD_CORNELL_BOX)
        print(f"  oracle render: {time.perf_counter() - t0:.0f} s",
              file=sys.stderr)
        np.savez_compressed(ORACLE_CACHE, img=oracle, spp=pp * pp,
                            seed=seed, world=3)
    else:
        oracle = np.load(ORACLE_CACHE)["img"]

    cfg = RenderConfig(width=w, height=h, pp=pp, seed=seed)
    img, _, _ = render_image(scene, cam, cfg)
    img = np.asarray(img)
    e = float(np.sqrt(((img - oracle) ** 2).mean()))
    d = np.abs(img - oracle).max(axis=-1)
    e1024 = e / np.sqrt(1024.0)
    med = float(np.median(d))
    flips = float((d > 1e-2).mean())
    return {
        "metric": "rmse_vs_oracle",
        "workload": "cornell 1280x720, 1 spp; RMSE extrapolated to "
                    "1024 spp by 1/sqrt(spp)",
        "rmse_1spp": e,
        "rmse_1024spp_extrapolated": float(e1024),
        "median_absdiff": med,
        "frac_gt_1e-2": flips,
        "gate": 1e-3,
        "ok": bool(e1024 < 1e-3 and med < 1e-4 and flips < 1e-4),
    }


if __name__ == "__main__":
    sys.exit(main())
