"""Profiling & metrics: wall-clock phases, Mrays/sec, JAX profiler traces.

The reference has essentially no instrumentation (SURVEY.md §5: the only
instrument is an unused rdtsc calibration, inf_forge_win.c:357-377). This
renderer makes perf a first-class output: every render reports rays cast,
wall-clock per phase, and Mrays/sec — the BASELINE.json headline metric —
and can capture a JAX profiler trace for xprof.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Dict, Optional

import jax


@dataclasses.dataclass
class PhaseTimer:
    """Accumulates wall-clock per named phase."""
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        return "  ".join(f"{k}={v:.3f}s" for k, v in self.phases.items())


@dataclasses.dataclass
class RenderMetrics:
    rays_cast: float
    wall_seconds: float
    width: int
    height: int
    spp: int
    nan_samples: float = 0.0

    @property
    def mrays_per_sec(self) -> float:
        return self.rays_cast / self.wall_seconds / 1e6 if self.wall_seconds > 0 else 0.0

    @property
    def samples_per_sec(self) -> float:
        return self.width * self.height * self.spp / self.wall_seconds \
            if self.wall_seconds > 0 else 0.0

    def json_line(self, vs_baseline_target: Optional[float] = None) -> str:
        d = {
            "metric": "Mrays/sec",
            "value": round(self.mrays_per_sec, 3),
            "unit": "Mrays/s",
        }
        if vs_baseline_target:
            d["vs_baseline"] = round(self.mrays_per_sec / vs_baseline_target, 4)
        return json.dumps(d)


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """Capture a JAX profiler trace (view with xprof/tensorboard) when a
    directory is given; no-op otherwise."""
    if log_dir:
        jax.profiler.start_trace(log_dir)
        try:
            yield
        finally:
            jax.profiler.stop_trace()
    else:
        yield


def block_until_ready(tree):
    return jax.block_until_ready(tree)
