"""On the card (marker ``cuda``; skips without one): a short run of each
one-card cell through the command, its last line parsed."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("name", ["recon642-b128-whole", "mesh164k-v32-512-whole"])
@pytest.mark.parametrize("trace", [0, 1])
def test_short_run(card, name, trace):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", name, "--seed",
                          "3000000001", "--seconds", "1", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
