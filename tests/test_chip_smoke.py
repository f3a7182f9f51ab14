"""chip_smoke.py's contract, checked on the CPU: the rehearsal runs every
phase at tiny sizes and ends with the JSON result line; without a GPU
and without --rehearse it exits nonzero naming the platform and prints
no result; alone in a directory it cannot run; a failed phase makes the
exit code nonzero. The script is run once per module, in a child process
(it selects its JAX platform before importing JAX)."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


def _env(tmp, **extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["JAX_COMPILATION_CACHE_DIR"] = os.path.join(str(tmp), "jax_cache")
    env.update(extra)
    return env


def run_smoke(args, tmp, script=SCRIPT, timeout=600, **env):
    return subprocess.run([sys.executable, script, *args], cwd=REPO,
                          env=_env(tmp, **env), capture_output=True,
                          text=True, timeout=timeout)


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("smoke")
    out = run_smoke(["--rehearse", "--out", str(tmp / "out")], tmp)
    return out, tmp


def _lines(out, phase):
    return [ln for ln in out.stdout.splitlines() if ln.startswith(phase)]


def test_rehearsal_exits_zero(rehearsal):
    out, _ = rehearsal
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]


def test_device_phase(rehearsal):
    out, tmp = rehearsal
    text = "\n".join(_lines(out, "device:"))
    assert '"platform": "cpu"' in text
    assert "nvidia-smi name,power.limit" in text
    assert f"compile cache {tmp / 'jax_cache'}" in text
    assert "device: ok" in text


def test_cli_phase(rehearsal):
    out, tmp = rehearsal
    assert "cli: ok" in out.stdout
    bmp = tmp / "out" / "w3.bmp"
    assert bmp.stat().st_size == 58 + 24 * 16 * 4


def test_worlds_phase(rehearsal):
    out, _ = rehearsal
    text = "\n".join(_lines(out, "worlds:"))
    for world in (1, 2, 3, 4, 6, 7):
        assert f"worlds: world {world}: 24x16 1 spp: compile" in text
    assert "worlds: world 5: unavailable: mesh asset absent" in text
    assert "us/iteration; state-traffic floor" in text
    assert "worlds: ok" in text


def test_fidelity_phase(rehearsal):
    out, _ = rehearsal
    lines = _lines(out, "fidelity:")
    gated = [ln for ln in lines if "(gate" in ln]
    assert len(gated) == 6, lines  # Cornell full frame + 5 row worlds
    assert all("FAIL" not in ln for ln in gated), gated
    assert "fidelity: ok" in out.stdout


def test_last_line_contract(rehearsal):
    import jax
    out, _ = rehearsal
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last == {"ok": True, "device": {
        "platform": "cpu", "kind": jax.devices()[0].device_kind,
        "count": 1}}


def test_no_gpu_exits_nonzero_and_names_platform(tmp_path):
    out = run_smoke([], tmp_path, JAX_PLATFORMS="cpu", timeout=120)
    assert out.returncode == 2
    assert "'cpu'" in out.stderr
    assert '"ok"' not in out.stdout


def test_alone_in_a_directory_fails(tmp_path):
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(SCRIPT, alone / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=alone,
                         env=_env(tmp_path), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_failed_phase_exits_nonzero(tmp_path, monkeypatch, capsys):
    sys.path.insert(0, REPO)
    import chip_smoke

    def boom(self):
        raise RuntimeError("injected")

    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setattr(chip_smoke.Smoke, "phase_cli", boom)
    monkeypatch.setattr(chip_smoke.Smoke, "phase_worlds", lambda self: None)
    monkeypatch.setattr(chip_smoke.Smoke, "phase_fidelity",
                        lambda self: None)
    assert chip_smoke.main(["--rehearse", "--out", str(tmp_path)]) == 1
    stdout = capsys.readouterr().out
    assert "cli: FAILED: RuntimeError: injected" in stdout
    last = json.loads(stdout.strip().splitlines()[-1])
    assert last == {"ok": False, "failed": ["cli"]}
