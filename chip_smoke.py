#!/usr/bin/env python3
"""Smoke test of the renderer on an NVIDIA GPU: the main path, once, checked.

Everything runs in one process (oracle rows are computed by CPU-only worker
processes that never open the card). Phases, each printed on its own lines:

  device    JAX version, device record, nvidia-smi name and power limit,
            compile-cache directory
  cli       ``python -m pathtracer_tpu -w3 -p4 --size 1280x720`` in-process;
            checks the BMP it writes
  worlds    ``render_image`` at 1280x720 and 16 spp for every world: compile
            seconds, wall time after a warm-up, Mrays/s, the compiled
            render_chunk's memory analysis, peak device memory; for Cornell
            also the time per wavefront-loop iteration beside the floor set
            by moving the loop state through HBM
  fidelity  1-spp renders against the scalar CPU oracle
            (reference/cpu_oracle.py): Cornell's full frame against the
            committed images/oracle_cornell_720p_1spp.npz, the other worlds
            on four fixed rows; every value is printed beside its gate
  four      (``--four`` only, and then the only phase) Cornell and world 1
            through ``render_image_sharded`` over four cards against
            ``render_image`` on one, in the same process

The last stdout line is ``{"ok": true, "device": {...}}`` when every phase
passed. A failed phase makes the exit code 1. Without a GPU the script
exits 2, names the platform it found and prints no result, unless
``--rehearse`` asks for the CPU rehearsal at tiny sizes (with ``--four``:
on four virtual CPU devices).

    python3 chip_smoke.py                      # one GPU
    python3 chip_smoke.py --four               # four GPUs, sharded phase
    python3 chip_smoke.py --rehearse [--four]  # CPU rehearsal
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

# HBM bandwidth of one H100 SXM (NVIDIA data sheet), for the loop-state
# floor of the Cornell phase.
H100_HBM_BYTES_PER_S = 3.35e12
# Per-lane arrays the wavefront loop carries (render/wavefront._WaveState):
# s_rel, bounce, o, d, thr, prad, sum, sum_sq (3 each but the first two),
# count.
WAVE_STATE_ARRAYS = 21

# Four fixed rows per world for the row-subset oracle comparison at
# 1280x720 and 1 spp. The CPU rehearsal compares whole 24x16 frames at
# 4 spp instead, the size and sample count of tests/test_golden.py: on so
# few pixels a single boundary flip at 1 spp outweighs the RMSE gates.
ROWS_FULL = (100, 300, 420, 620)
# tests/test_golden.py's gates per world kind: "plain" worlds hold RMSE
# < 1e-3; "textured" ones (texel and silhouette boundaries turn ulp
# differences into whole-sample flips) hold median |d| < 1e-4, fewer
# than 5% of pixels with |d| > 1e-2 and RMSE < 5e-3.
ROW_WORLDS = {0: "textured", 1: "plain", 3: "textured", 5: "plain",
              6: "textured"}
TEXTURED_GATES = (("median_absdiff", 1e-4), ("frac_gt_1e-2", 0.05),
                  ("rmse", 5e-3))
PLAIN_GATES = (("rmse", 1e-3),)
# bench.py --rmse's gates on Cornell's full frame (RMSE extrapolated to
# 1024 spp by 1/sqrt(spp)).
CORNELL_GATES = (("rmse_1024spp_extrapolated", 1e-3),
                 ("median_absdiff", 1e-4), ("frac_gt_1e-2", 1e-4))
# Sharded vs single-device images: bit-equal is expected (every random
# number and every per-lane operation is a function of the pixel index);
# if they differ, the differences must be isolated boundary flips.
SHARDED_GATES = (("median_absdiff", 0.0), ("frac_gt_1e-2", 1e-4))


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded phase")
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU rehearsal at tiny sizes (no GPU needed)")
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "chip_smoke"),
                    help="directory for the CLI's image")
    return ap.parse_args(argv)


def _oracle_rows(kind, width, height, pp, camera, rows):
    """Worker-process body: the oracle's rows of world ``kind``."""
    from pathtracer_tpu.reference.cpu_oracle import render_oracle
    from pathtracer_tpu.scene.worlds import build_world
    builder, _ = build_world(kind)
    return render_oracle(builder, camera, width, height, pp, seed=0,
                         world_kind=kind, row_range=rows)


def _diff_stats(img, ref):
    import numpy as np
    img = np.asarray(img, np.float64)
    ref = np.asarray(ref, np.float64)
    d = np.abs(img - ref).max(axis=-1)
    return {"rmse": float(np.sqrt(((img - ref) ** 2).mean())),
            "median_absdiff": float(np.median(d)),
            "frac_gt_1e-2": float((d > 1e-2).mean()),
            "max_absdiff": float(d.max())}


def _check(ok, message):
    """A result check that stays under ``python -O``."""
    if not ok:
        raise AssertionError(message)


def _gate(label, stats, gates):
    """Print every gated value beside its gate; raise if any misses."""
    parts, missed = [], []
    for name, limit in gates:
        v = stats[name]
        ok = v <= limit if limit == 0.0 else v < limit
        parts.append(f"{name} {v!r} (gate {'<=' if limit == 0.0 else '<'} "
                     f"{limit!r}) {'PASS' if ok else 'FAIL'}")
        if not ok:
            missed.append(name)
    print(f"{label}: " + "; ".join(parts), flush=True)
    if missed:
        raise AssertionError(f"{label}: gate missed for {missed}")


class Smoke:
    def __init__(self, args):
        import jax
        import jax.numpy as jnp
        import numpy as np
        from pathtracer_tpu import device as dev
        self.jax, self.jnp, self.np, self.dev = jax, jnp, np, dev
        self.args = args
        self.rehearse = args.rehearse
        self.w, self.h = (24, 16) if self.rehearse else (1280, 720)
        self.pp = 1 if self.rehearse else 4
        self.rows = tuple(range(self.h)) if self.rehearse else ROWS_FULL
        self.fid_pp = 2 if self.rehearse else 1
        self.record = dev.device_record()
        self.smi = dev.nvidia_smi()
        if self.rehearse:
            self.tag = "[CPU rehearsal: host clock, no device timing]"
        else:
            if not self.smi:
                raise RuntimeError("nvidia-smi gave no name,power.limit")
            self.tag = f"[{self.smi[0]}]"

    # -- phases ------------------------------------------------------------
    def phase_device(self):
        jax = self.jax
        cache = self.dev.setup_compile_cache()
        print(f"device: jax {jax.__version__}; record {json.dumps(self.record)}")
        for line in self.smi or ["unavailable"]:
            print(f"device: nvidia-smi name,power.limit: {line}")
        print(f"device: compile cache {cache}", flush=True)

    def phase_cli(self):
        from pathtracer_tpu import cli
        from pathtracer_tpu.io.bmp import read_bmp
        os.makedirs(self.args.out, exist_ok=True)
        path = os.path.join(self.args.out, "w3.bmp")
        argv = ["-w3", f"-p{self.pp}", "--size", f"{self.w}x{self.h}",
                "--out", path]
        t0 = time.perf_counter()
        rc = cli.main(argv)
        wall = time.perf_counter() - t0
        _check(rc == 0, f"cli exit code {rc}")
        size = os.path.getsize(path)
        want = 58 + self.w * self.h * 4
        packed = read_bmp(path)
        _check(size == want and packed.shape == (self.h, self.w),
               f"BMP is {size} bytes, {packed.shape}; want {want} bytes")
        _check((packed & 0x00FFFFFF).any(), "CLI image is black")
        print(f"cli: -w3 -p{self.pp} --size {self.w}x{self.h} wrote {path} "
              f"({size} bytes, {packed.shape[1]}x{packed.shape[0]}); "
              f"process wall incl. compile {wall!r} s {self.tag}", flush=True)

    def phase_worlds(self):
        from pathtracer_tpu import RenderConfig, finalize_world, render_image
        from pathtracer_tpu.render.renderer import init_accum, render_chunk
        from pathtracer_tpu.scene.schema import (
            WORLD_CORNELL_BOX, WORLD_KIND_COUNT, WORLD_MARIO,
        )
        from pathtracer_tpu.utils import prng
        jax, jnp, np = self.jax, self.jnp, self.np
        w, h, n = self.w, self.h, self.w * self.h
        for kind in range(WORLD_KIND_COUNT):
            label = f"worlds: world {kind + 1}"
            scene, cam = finalize_world(kind, w, h)
            if kind == WORLD_MARIO and scene.n_tris == 0:
                print(f"{label}: unavailable: mesh asset absent", flush=True)
                continue
            cfg = RenderConfig(width=w, height=h, pp=self.pp, seed=0)
            key = prng.base_key(0)
            t0 = time.perf_counter()
            compiled = render_chunk.lower(
                scene, cam, cfg, key, jnp.int32(0), cfg.spp,
                init_accum(n)).compile()
            compile_s = time.perf_counter() - t0
            ma = compiled.memory_analysis()
            jax.block_until_ready(render_image(scene, cam, cfg)[:2])
            t0 = time.perf_counter()
            img, packed, st = render_image(scene, cam, cfg)
            jax.block_until_ready((img, packed))
            wall = time.perf_counter() - t0
            img = np.asarray(img)
            rays = float(st.rays_cast)
            _check(img.shape == (h, w, 3), f"image shape {img.shape}")
            _check(np.isfinite(img).all(), "non-finite pixels")
            _check(img.max() > 0.0, "image is black")
            _check(rays > 0.0, "no rays cast")
            stats = jax.devices()[0].memory_stats() or {}
            peak = stats.get("peak_bytes_in_use", "not available")
            mem = ("not available" if ma is None else
                   f"argument {ma.argument_size_in_bytes} B, output "
                   f"{ma.output_size_in_bytes} B, temp {ma.temp_size_in_bytes}"
                   f" B, alias {ma.alias_size_in_bytes} B")
            print(f"{label}: {w}x{h} {cfg.spp} spp: compile {compile_s!r} s; "
                  f"wall {wall!r} s; {rays / wall / 1e6!r} Mrays/s "
                  f"({rays!r} rays); render_chunk memory: {mem}; "
                  f"peak_bytes_in_use {peak} {self.tag}", flush=True)
            if kind == WORLD_CORNELL_BOX:
                self._cornell_iterations(scene, cam, cfg, compiled, key)

    def _cornell_iterations(self, scene, cam, cfg, compiled, key):
        """Time per wavefront-loop iteration beside the state-traffic
        floor. The loop runs until the busiest lane is done, so its
        iteration count is the largest per-pixel number of rays cast,
        which the bounce-count debug render gives exactly."""
        import dataclasses
        from pathtracer_tpu import render_image
        from pathtracer_tpu.render.integrator import BOUNCE_COUNT
        from pathtracer_tpu.render.renderer import init_accum
        from pathtracer_tpu.scene.schema import MAX_BOUNCE_COUNT
        jax, jnp, np = self.jax, self.jnp, self.np
        n = cfg.width * cfg.height
        dbg = dataclasses.replace(cfg, debug_kind=BOUNCE_COUNT)
        img, _, st = render_image(scene, cam, dbg)
        casts = np.rint(np.asarray(img)[..., 0].astype(np.float64)
                        * cfg.spp * MAX_BOUNCE_COUNT)
        iters = int(casts.max())
        state = init_accum(n)
        jax.block_until_ready(state)
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(scene, key, jnp.int32(0), state))
        dt = time.perf_counter() - t0
        floor = WAVE_STATE_ARRAYS * 4 * n * 2 / H100_HBM_BYTES_PER_S
        print(f"worlds: world 3 loop: {iters} iterations; render_chunk "
              f"{dt!r} s = {dt / iters * 1e6!r} us/iteration; state-traffic "
              f"floor {floor * 1e6!r} us/iteration "
              f"({WAVE_STATE_ARRAYS} x 4 B x {n} lanes x 2 / 3.35 TB/s) "
              f"{self.tag}", flush=True)

    def phase_fidelity(self):
        import multiprocessing as mp
        from pathtracer_tpu import RenderConfig, finalize_world, render_image
        from pathtracer_tpu.scene.schema import WORLD_CORNELL_BOX
        np = self.np
        w, h, pp, rows = self.w, self.h, self.fid_pp, list(self.rows)
        cams = {k: finalize_world(k, w, h)[1] for k in ROW_WORLDS}
        # slowest (the 1472-triangle mesh, then the 494 spheres) first;
        # one row per task on the card, four in the rehearsal
        order = sorted(ROW_WORLDS, key=lambda k: (k != 6, k != 3, k))
        step = 4 if self.rehearse else 1
        parts = [tuple(rows[i:i + step]) for i in range(0, len(rows), step)]
        row_label = "all" if self.rehearse else str(tuple(rows))
        tasks = [(k, part) for k in order for part in parts]
        n_proc = max(1, min(len(tasks), (os.cpu_count() or 2) - 2,
                            4 if self.rehearse else len(tasks)))
        ctx = mp.get_context("spawn")
        saved = os.environ.get("JAX_PLATFORMS")
        os.environ["JAX_PLATFORMS"] = "cpu"  # workers never open the card
        try:
            pool = ctx.Pool(n_proc)
        finally:
            if saved is None:
                os.environ.pop("JAX_PLATFORMS")
            else:
                os.environ["JAX_PLATFORMS"] = saved
        with pool:
            pending = {t: pool.apply_async(
                _oracle_rows, (t[0], w, h, pp, cams[t[0]], list(t[1])))
                for t in tasks}
            failed = []
            # Cornell's full frame while the workers run
            scene, cam = finalize_world(WORLD_CORNELL_BOX, w, h)
            cfg = RenderConfig(width=w, height=h, pp=pp, seed=0)
            img = np.asarray(render_image(scene, cam, cfg)[0])
            if self.rehearse:
                ref = _oracle_rows(WORLD_CORNELL_BOX, w, h, pp, cam,
                                   range(h))
            else:
                ref = np.load(os.path.join(
                    os.path.dirname(os.path.abspath(__file__)), "images",
                    "oracle_cornell_720p_1spp.npz"))["img"]
            stats = _diff_stats(img, ref)
            stats["rmse_1024spp_extrapolated"] = (stats["rmse"]
                                                  * (cfg.spp / 1024) ** 0.5)
            try:
                _gate(f"fidelity: world 3 full frame {w}x{h} {cfg.spp} spp "
                      f"(rmse {stats['rmse']!r})", stats, CORNELL_GATES)
            except AssertionError as e:
                failed.append(str(e))
            for kind in order:
                scene, cam = finalize_world(kind, w, h)
                img = np.asarray(render_image(scene, cam, cfg)[0])[rows]
                ref = np.concatenate([pending[(kind, part)].get()
                                      for part in parts])
                gates = (TEXTURED_GATES if ROW_WORLDS[kind] == "textured"
                         else PLAIN_GATES)
                stats = _diff_stats(img, ref)
                try:
                    _gate(f"fidelity: world {kind + 1} rows {row_label} "
                          f"of {w}x{h} {cfg.spp} spp (max_absdiff "
                          f"{stats['max_absdiff']!r})", stats, gates)
                except AssertionError as e:
                    failed.append(str(e))
        if failed:
            raise AssertionError("; ".join(failed))

    def phase_four(self):
        from pathtracer_tpu import RenderConfig, finalize_world, render_image
        from pathtracer_tpu.parallel.shard import (
            make_mesh, render_image_sharded,
        )
        from pathtracer_tpu.scene.schema import (
            WORLD_CORNELL_BOX, WORLD_DEFAULT,
        )
        jax, np = self.jax, self.np
        devices = jax.devices()
        _check(len(devices) >= 4,
               f"--four needs 4 devices, found {len(devices)}")
        mesh = make_mesh(devices[:4])
        w, h = self.w, self.h
        failed = []
        for kind in (WORLD_CORNELL_BOX, WORLD_DEFAULT):
            scene, cam = finalize_world(kind, w, h)
            cfg = RenderConfig(width=w, height=h, pp=self.pp, seed=0)
            shards = []

            def grab(s_done, total, st):
                shards[:] = [(str(s.device), tuple(s.data.shape))
                             for s in st.sum.x.addressable_shards]

            def sharded():
                return render_image_sharded(scene, cam, cfg, mesh=mesh,
                                            progress_cb=grab)

            def single():
                return render_image(scene, cam, cfg)

            times, imgs = {}, {}
            for name, fn in (("sharded", sharded), ("single", single)):
                jax.block_until_ready(fn()[:2])  # warm-up and compile
                t0 = time.perf_counter()
                out = fn()
                jax.block_until_ready(out[:2])
                times[name] = time.perf_counter() - t0
                imgs[name] = np.asarray(out[0])
            label = f"four: world {kind + 1} {w}x{h} {cfg.spp} spp"
            for dev_name, shape in shards:
                print(f"{label}: shard on {dev_name}: {shape} of {w * h} "
                      f"pixels", flush=True)
            _check(len(shards) == 4 and all(s[1][0] < w * h for s in shards),
                   f"shards {shards}")
            print(f"{label}: sharded over 4 devices {times['sharded']!r} s; "
                  f"single device {times['single']!r} s {self.tag}",
                  flush=True)
            a, b = imgs["sharded"], imgs["single"]
            if np.array_equal(a, b):
                print(f"{label}: sharded image bit-equal to single-device "
                      f"image", flush=True)
                continue
            stats = _diff_stats(a, b)
            stats["frac_pixels_differing"] = float(
                (np.abs(a - b).max(axis=-1) > 0).mean())
            try:
                _gate(f"{label}: sharded vs single, not bit-equal "
                      f"(frac_pixels_differing "
                      f"{stats['frac_pixels_differing']!r}, max_absdiff "
                      f"{stats['max_absdiff']!r})", stats, SHARDED_GATES)
            except AssertionError as e:
                failed.append(str(e))
        if failed:
            raise AssertionError("; ".join(failed))


def main(argv=None) -> int:
    args = _parse(argv)
    if args.rehearse:
        os.environ["JAX_PLATFORMS"] = "cpu"
        if args.four and "device_count" not in os.environ.get("XLA_FLAGS",
                                                             ""):
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "")
                + " --xla_force_host_platform_device_count=4").strip()
    from pathtracer_tpu import device as dev
    if not args.rehearse:
        try:
            dev.require_gpu()
        except dev.NoGPUError as e:
            print(f"chip_smoke: {e}; run with --rehearse for the CPU "
                  f"rehearsal", file=sys.stderr)
            return 2
    smoke = Smoke(args)
    phases = (["device", "four"] if args.four
              else ["device", "cli", "worlds", "fidelity"])
    failed = []
    for name in phases:
        t0 = time.perf_counter()
        try:
            getattr(smoke, f"phase_{name}")()
        except Exception as e:  # noqa: BLE001 - reported, exit code 1
            traceback.print_exc()
            print(f"{name}: FAILED: {type(e).__name__}: {e}", flush=True)
            failed.append(name)
        else:
            print(f"{name}: ok ({time.perf_counter() - t0!r} s)", flush=True)
    if failed:
        print(json.dumps({"ok": False, "failed": failed}))
        return 1
    rec = smoke.record
    print(json.dumps({"ok": True, "device": {
        "platform": rec["platform"], "kind": rec["kind"],
        "count": rec["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
