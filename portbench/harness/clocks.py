"""The cards' clocks, power draw, power limit and temperature, sampled
beside each window with ``nvidia-smi`` (read only), so that a process
that runs slower can be told apart from a change that does."""

from __future__ import annotations

import subprocess
import sys

QUERY = "index,name,clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu"


def sample():
    """One line per card, or the reason there is none."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={QUERY}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        return [f"nvidia-smi not read: {exc}"]
    return [line.strip() for line in out.strip().splitlines()]


def log(when):
    """Print the sample on standard error, labelled ``when``."""
    for line in sample():
        print(f"[clocks] {when}: {line} ({QUERY})", file=sys.stderr, flush=True)
