"""The accelerator a run uses: its record, its power limit, its compile cache.

The entry points (the CLI, bench.py, chip_smoke.py, __graft_entry__.py)
call these helpers; importing the package sets nothing, so CPU test runs
write no compile cache into the tree.

- ``device_record()``: platform, device kind and device count, as JAX
  reports them.
- ``require_gpu()``: the record, or ``NoGPUError`` naming the platform
  found. Measurement paths call it and never fall back to the CPU.
- ``nvidia_smi()``: the card's name and power limit, read from a child
  process that never imports JAX (a second JAX process would reserve the
  card's memory).
- ``setup_compile_cache()``: JAX's persistent compile cache. Where
  ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already keeps it there and
  nothing else is set; otherwise it goes to ``<checkout>/.jax_cache``, a
  fixed path, because the path is part of the cache key.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import List, Optional

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_DIR = os.path.join(CHECKOUT, ".jax_cache")
SMI_QUERY = ("--query-gpu=name,power.limit", "--format=csv,noheader")


class NoGPUError(RuntimeError):
    """JAX found no GPU; the message names the platform it found."""


def device_record() -> dict:
    import jax
    devices = jax.devices()
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices)}


def require_gpu() -> dict:
    rec = device_record()
    if rec["platform"] != "gpu":
        raise NoGPUError(
            f"no GPU: JAX found platform {rec['platform']!r} "
            f"({rec['kind']}, {rec['count']} device(s))")
    return rec


def nvidia_smi(timeout: float = 30.0) -> Optional[List[str]]:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``,
    one line per card, or None where the tool is absent or fails."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        out = subprocess.run([exe, *SMI_QUERY], capture_output=True,
                             text=True, timeout=timeout, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    return lines or None


def setup_compile_cache() -> str:
    """Place JAX's persistent compile cache; returns its directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    import jax
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
