"""chip_smoke.py --four, rehearsed on four virtual CPU devices: only the
sharded phase runs, each device holds a quarter of the frame, the sharded
images equal the single-device ones, and the result line counts 4."""

import json

import pytest

from test_chip_smoke import run_smoke


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("smoke4")
    return run_smoke(["--rehearse", "--four", "--out", str(tmp)], tmp)


def test_four_exits_zero_and_runs_only_the_sharded_phase(four):
    assert four.returncode == 0, four.stdout[-3000:] + four.stderr[-3000:]
    phases = {ln.split(":")[0] for ln in four.stdout.splitlines()
              if ln.split(":")[0] in ("device", "cli", "worlds", "fidelity",
                                      "four")}
    assert phases == {"device", "four"}


def test_four_shards_and_equality(four):
    lines = [ln for ln in four.stdout.splitlines() if ln.startswith("four:")]
    for world in (3, 1):
        mine = [ln for ln in lines if f"world {world} " in ln]
        shards = [ln for ln in mine if ": shard on " in ln]
        assert len(shards) == 4 and all("(96,) of 384" in s for s in shards)
        assert any("bit-equal to single-device" in ln for ln in mine), mine
        assert any("sharded over 4 devices" in ln for ln in mine)
    last = json.loads(four.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["count"] == 4
