"""Every cell's code end to end at the tiny sizes on the CPU: a well-formed
result line; and the runs that must print no result."""

import json
import shutil
import subprocess
import sys

import pytest

from portbench.tests.common import BENCH, CELLS, MANIFEST, ROOT, rehearse


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_prints_a_well_formed_last_line(cell, trace):
    rc, line, err = rehearse(cell, trace=trace)
    assert rc == 0, err[-3000:]
    keys = list(line)
    assert keys[:4] == ["correct", "attempted", "failed", "metrics"] and keys[-1] == "checks"
    assert set(keys) <= {"correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"}
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert line["device"]["platform"] == "cpu" and line["device"]["count"] == 1
    wanted = MANIFEST["per_layer"] if trace else MANIFEST["end_to_end"]
    names = {m["name"] for m in wanted if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name
    # the numbers compared are the last lines on standard error
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") for t in tail)
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_card_no_result():
    rc, line, err = rehearse(CELLS[0], args=())
    assert rc != 0 and line is None and "CUDA card" in err


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    cmd = [sys.executable, "-m", "portbench.run", "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
           "--trace", "0", "--rehearse"]
    proc = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True, timeout=300, env={"PATH": ""})
    assert proc.returncode != 0 and not proc.stdout.strip()
