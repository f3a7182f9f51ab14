"""The device helper (pathtracer_tpu/device.py) and bench.py's device record:
no GPU is an error, never a fallback; nvidia-smi is read from a child
process; the compile cache goes where JAX_COMPILATION_CACHE_DIR says, or
to one fixed directory in the checkout."""

import json
import os
import subprocess
import sys

import pytest

from pathtracer_tpu import device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fake_smi(tmp_path, body):
    exe = tmp_path / "nvidia-smi"
    exe.write_text("#!/bin/sh\n" + body)
    exe.chmod(0o755)
    return str(tmp_path)


def test_no_gpu_raises_naming_the_platform():
    with pytest.raises(device.NoGPUError, match="'cpu'"):
        device.require_gpu()


def test_record_fields():
    import jax
    rec = device.device_record()
    assert rec == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())}


def test_nvidia_smi_canned(tmp_path, monkeypatch):
    path = _fake_smi(tmp_path, 'echo "$@" > "${0%/*}/args"\n'
                     'echo "NVIDIA H100 80GB HBM3, 700.00 W"\n')
    monkeypatch.setenv("PATH", path)
    assert device.nvidia_smi() == ["NVIDIA H100 80GB HBM3, 700.00 W"]
    args = (tmp_path / "args").read_text().split()
    assert args == ["--query-gpu=name,power.limit", "--format=csv,noheader"]


def test_nvidia_smi_absent_or_failing(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    assert device.nvidia_smi() is None
    monkeypatch.setenv("PATH", _fake_smi(tmp_path, "exit 9\n"))
    assert device.nvidia_smi() is None


_PRINT_CACHE = (
    "import jax; from pathtracer_tpu import device; "
    "p = device.setup_compile_cache(); "
    "print(p, jax.config.jax_compilation_cache_dir)")


def _cache_in_child(env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    out = subprocess.run([sys.executable, "-c", _PRINT_CACHE], cwd=REPO,
                         env=env, capture_output=True, text=True, check=True,
                         timeout=120)
    return out.stdout.split()


def test_cache_dir_from_environment(tmp_path):
    want = str(tmp_path / "cc")
    assert _cache_in_child(want) == [want, want]


def test_cache_dir_fixed_in_checkout_when_unset():
    first = _cache_in_child(None)
    second = _cache_in_child(None)
    want = os.path.join(REPO, ".jax_cache")
    assert first == second == [want, want]


def test_importing_the_package_sets_no_cache():
    code = ("import jax, pathtracer_tpu, pathtracer_tpu.cli; "
            "print(jax.config.jax_compilation_cache_dir)")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, check=True,
                         timeout=120)
    assert out.stdout.strip() == "None"


def test_bench_refuses_cpu_and_names_it(capsys):
    sys.path.insert(0, REPO)
    import bench
    assert bench.main(["--world", "3"]) == 1
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "cpu" in rec["error"] and "value" not in rec


def test_bench_device_fields(tmp_path, monkeypatch):
    sys.path.insert(0, REPO)
    import bench
    monkeypatch.setenv("PATH", _fake_smi(
        tmp_path, 'echo "NVIDIA H100 80GB HBM3, 700.00 W"\n'))
    fields = bench.device_fields()
    assert fields["device"] == device.device_record()
    assert fields["gpu"] == "NVIDIA H100 80GB HBM3, 700.00 W"


@pytest.mark.gpu
def test_gpu_record_and_power_limit(gpu):
    rec = device.require_gpu()
    assert rec["platform"] == "gpu" and rec["count"] >= 1
    smi = device.nvidia_smi()
    assert smi and len(smi) >= rec["count"]
