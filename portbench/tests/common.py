"""Helpers of the benchmark's CPU tests: run a cell's rehearsal (tiny
sizes on the CPU) and read its result line."""

import json
import os
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [c["name"] for c in MANIFEST["workloads"]]


def rehearse(cell: str, trace: int = 0, seed: int = 3_000_000_017, cwd: Path = ROOT, extra_path: str = "",
             args=("--rehearse",)):
    """Run ``python -m portbench.run`` on ``cell``; returns (rc, last stdout
    line as a dict or None, stderr)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (extra_path,) if p))
    cmd = [sys.executable, "-m", "portbench.run", "--workload", cell, "--seed", str(seed), "--seconds", "1",
           "--trace", str(trace), *args]
    proc = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    line = json.loads(lines[-1]) if lines else None
    return proc.returncode, line, proc.stderr


def run_in_process(cell: str, capsys, trace: int = 0, seed: int = 3_000_000_019) -> dict:
    """``run.main`` in this process (so that a test can plant a fault in
    the program underneath); returns the result line."""
    from portbench import run

    assert run.main(["--workload", cell, "--seed", str(seed), "--seconds", "1", "--trace", str(trace),
                     "--rehearse"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])
