"""A run driven past the look for a card, on the CPU at the tests' sizes,
with the timed path broken underneath: ``correct`` comes out false for
each fault the cell can have, and true without one."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

from portbench import run
from portbench.harness import runner, sharded

from .common import SEED, SMALL, TILE4

SINGLE = ["recon642-b128-whole", "mesh164k-v32-512-whole"]
FAULTS = [None, "frozen", "half_batch", "altered"]


@pytest.mark.parametrize("name", SINGLE)
@pytest.mark.parametrize("fault", FAULTS)
def test_single_device_run(name, fault):
    result = runner.single(name, SEED, 0.2, False, time.time(), device="cpu",
                           overrides=SMALL[name], fault=fault)
    assert result["correct"] is (fault is None), result["checks"]
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"pixels_per_s", "step_ms_p95", "peak_mem_mib", "setup_s"}


@pytest.mark.parametrize("fault", [None, "no_exchange", "half_batch"])
def test_sharded_run(fault):
    name = TILE4["name"]
    result = sharded.run(name, SEED, 0.2, False, time.time(), device="cpu",
                         overrides=SMALL[name], fault=fault, workload=TILE4)
    assert result["correct"] is (fault is None), result["checks"]
    assert result["device"]["count"] == 4
    assert set(result["metrics"]) == {"pixels_per_s", "step_ms_p95", "peak_mem_mib", "setup_s"}
    if fault == "no_exchange":
        assert result["checks"]["rank_gap"]["value"] > 0


def test_sharded_run_in_a_fresh_process():
    """The command's own process: nothing but the harness has loaded the
    port's modules before the sharded entry is reached."""
    code = ("import sys, time; sys.path.insert(0, '.')\n"
            "from portbench.harness import sharded\n"
            "from portbench.tests.common import SMALL, SEED, TILE4\n"
            "name = TILE4['name']\n"
            "r = sharded.run(name, SEED, 0.2, False, time.time(), device='cpu', "
            "overrides=SMALL[name], workload=TILE4)\n"
            "assert r['correct'], r['checks']\n")
    root = Path(__file__).resolve().parents[2]
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]


@pytest.mark.parametrize("guard, code", [(runner.FORBIDDEN, 0), (("torch",), 4)])
def test_a_rank_that_holds_a_forbidden_module_prints_no_result(guard, code, capsys):
    """The window of a sharded cell runs in its ranks: each reports the
    modules it holds once its window has closed, and a module whose
    top-level name is guarded (here a stand-in, ``torch``, which every
    gloo rank loads) leaves the run without a result line."""
    name = TILE4["name"]
    assert run.report(sharded.run, name, SEED, 0.2, False, time.time(), device="cpu",
                      overrides=SMALL[name], guard=guard, workload=TILE4) == code
    out, err = capsys.readouterr()
    if code:
        assert out == ""
        assert "torch.distributed" in err
    else:
        assert json.loads(out.strip().splitlines()[-1])["correct"] is True


@pytest.mark.parametrize("elapsed, total", [(0.25, 40), (1.5, 10)])
def test_the_sharded_window_fills_its_seconds_by_the_host_clock(monkeypatch, elapsed, total):
    """The ranks' window: its opening steps, then as many more as the host's
    clock over them says fill the seconds (none once they are past)."""
    monkeypatch.setattr(sharded, "_agree", lambda n, device: n)
    go = sharded.planned(10, 1.0, "cpu")
    assert all(go(n, 0.01 * n) for n in range(10))
    taken = 10 + sum(1 for n in range(10, 100) if go(n, elapsed))
    assert taken == total
