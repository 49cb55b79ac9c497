"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's); and the reference loads nothing of the program."""

import ast
import json
import subprocess
import sys

from portbench.tests.common import BENCH, CELLS, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "i2v_adapter_tpu"}

DRIVE = """
import io, json, sys, contextlib
from portbench import run, control
for cell in {cells!r}:
    for trace in (0, 1):
        with contextlib.redirect_stdout(io.StringIO()):
            assert run.main(["--workload", cell, "--seed", "7", "--seconds", "1", "--trace", str(trace),
                             "--rehearse"]) == 0
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_modules(code: str) -> set:
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_runs_load_no_jax():
    names = top_level_modules(DRIVE.format(cells=CELLS))
    assert "i2v_adapter_tpu_torch" in names  # the program was run
    assert not names & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    code = ("import json, sys\n"
            "from portbench.reference import model, serve, train, lower\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    names = top_level_modules(code)
    assert "i2v_adapter_tpu_torch" not in names and not names & FORBIDDEN


def test_reference_sources_import_no_program():
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in FORBIDDEN | {"i2v_adapter_tpu_torch"}, (path.name, mod)
                if top == "portbench":
                    assert mod in ("portbench", "portbench.weights") or mod.startswith("portbench.reference"), mod
