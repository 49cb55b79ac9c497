"""``BENCHMARK.json`` against the benchmark's contract, and discovery by
name: a configuration, a traffic mix, a per-layer metric and a kernel
family added as new files and manifest entries alone, with no file of the
benchmark edited."""

import json
import re
import shutil

from portbench.tests.common import BENCH, MANIFEST, ROOT, rehearse

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_keys_names_and_files():
    m = MANIFEST
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["portbench"] and m["command"][:3] == ["python3", "-m", "portbench.run"]
    assert 1 <= m["run_seconds"] <= 51
    configs = {c["name"]: c for c in m["configs"]}
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["source"] == c["source"] and data["reduced"] == c["reduced"] and "assumed" in data
        assert any(w["config"] == c["name"] for w in m["workloads"])
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for x in m["end_to_end"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= x["bound"] <= 0.25 and x["source"] in ("host_clock", "device_trace")
    pairs = set()
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        for sub in (f"traffic/{w['traffic']}.json", f"limits/{w['name']}.json"):
            assert (BENCH / sub).is_file(), sub
        reports = [x for x in m["end_to_end"] if w["name"] in x.get("workloads", [w["name"]])]
        assert "setup_s" in {x["name"] for x in reports} and len(reports) >= 2
        assert any(w["name"] in p.get("workloads", [w["name"]]) for p in m["per_layer"])
    layers = {}
    for p in m["per_layer"]:
        assert set(p) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert NAME.match(p["name"]) and UNIT.match(p["unit"]) and p["moves"] in e2e
        assert (BENCH / "metrics" / f"{p['name']}.py").is_file()
        for cell in p["workloads"]:
            assert cell in e2e[p["moves"]].get("workloads", [cell])
        if "roofline" in p["name"] or "mfu" in p["name"]:
            assert p["unit"] == "%"
        layers.setdefault(p["layer"].lower(), p["layer"])
    assert all(UNIT.match(x["unit"]) for x in m["end_to_end"])
    assert len(json.dumps(m)) < 64 * 1024


def test_a_cell_is_added_from_new_files_alone(tmp_path):
    """Copy the benchmark, add a configuration, a mix, a metric and a kernel
    family as new files, name them in the manifest, and run the new cell."""
    shutil.copytree(BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    m = json.loads(json.dumps(MANIFEST))
    base = json.loads((BENCH / "configs" / "i2v_sd15_serve.json").read_text())
    (tmp_path / "portbench/configs/extra_config.json").write_text(json.dumps(dict(base, name="extra_config")))
    mix = json.loads((BENCH / "traffic" / "clip256.json").read_text())
    (tmp_path / "portbench/traffic/extra_mix.json").write_text(json.dumps(dict(mix, prompt_words=[1, 3])))
    (tmp_path / "portbench/limits/extra_cell.json").write_text(json.dumps({"limits": {"later_frames_rms_max": 1e9}}))
    (tmp_path / "portbench/kernels/extra_family.py").write_text(
        'PATTERNS = ("no_such_kernel",)\nPEAK = "bf16_flops"\n\n\n'
        'def work(site):\n    return (site.ops, 0) if site.kind == "conv" else None\n')
    (tmp_path / "portbench/metrics/extra_bound_ms.py").write_text(
        "import importlib\n\nfrom portbench.readers import bound_s\n\n\n"
        "def read(ctx):\n    fam = importlib.import_module('portbench.kernels.extra_family')\n"
        "    return 1e3 * bound_s(ctx, fam.work, fam.PEAK)\n")
    m["configs"].append(dict(m["configs"][0], name="extra_config", file="portbench/configs/extra_config.json"))
    m["workloads"].append({"name": "extra_cell", "config": "extra_config", "traffic": "extra_mix", "chips": 1,
                           "why": "a throwaway cell"})
    for x in m["end_to_end"]:
        if "workloads" in x and "serve256_clip" in x["workloads"]:
            x["workloads"].append("extra_cell")
    m["per_layer"].append({"name": "extra_bound_ms", "unit": "ms", "better": "lower", "source": "program_counter",
                           "layer": "kernels", "moves": "clip_latency_s", "workloads": ["extra_cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    rc, line, err = rehearse("extra_cell", trace=1, cwd=tmp_path, extra_path=str(ROOT))
    assert rc == 0, err[-3000:]
    assert line["metrics"]["extra_bound_ms"]["value"] > 0 and line["checks"]
    # no file of the benchmark was edited to get there
    for f in BENCH.rglob("*"):
        if f.is_file() and "__pycache__" not in f.parts and "tests" not in f.parts:
            assert (tmp_path / "portbench" / f.relative_to(BENCH)).read_bytes() == f.read_bytes()
