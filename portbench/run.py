"""Run one benchmark cell once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Everything is found by name: the cell in
``BENCHMARK.json``, its configuration in ``configs/<config>.json``, its
traffic mix in ``traffic/<traffic>.json`` (whose ``kind`` names the module
that runs the cell, ``serve`` or ``train``), the limits of its correctness check in
``limits/<workload>.json``, each per-layer metric's reader in
``metrics/<name>.py`` and each kernel family in ``kernels/<family>.py``.

With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a traced slice of the
window and from the untraced rest.  The numbers compared with the
reference are printed with their limits as the last lines on standard
error and under ``checks``, the line's last key.  The run needs as many
CUDA cards as the cell asks for; ``--rehearse`` runs the cell's code at the
tiny sizes of ``rehearse.json`` on the CPU instead, and says so in
``device``.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import platform  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# caches of the program's builds and compiles, at fixed paths in the checkout
CACHE = ROOT / ".portbench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "i2v_adapter_tpu")


def fail(msg: str, code: int = 2) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def load_json(path: Path) -> dict:
    if not path.is_file():
        fail(f"missing {path.relative_to(ROOT)}")
    with open(path) as f:
        return json.load(f)


def find_cell(manifest: dict, name: str) -> dict:
    for cell in manifest["workloads"]:
        if cell["name"] == name:
            return cell
    fail(f"no workload {name!r} in BENCHMARK.json")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def reader(name: str):
    """The ``read(ctx)`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    if spec is None or not path.is_file():
        fail(f"no reader metrics/{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=int, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true",
                   help="run at the tiny sizes of rehearse.json on the CPU (never a measurement)")
    return p.parse_args(argv)


def environment(args) -> SimpleNamespace:
    """The cell's files, the device and the helpers a cell's loop uses."""
    manifest = load_json(ROOT / "BENCHMARK.json")
    cell = find_cell(manifest, args.workload)
    config = load_json(HERE / "configs" / f"{cell['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{cell['name']}.json")["limits"]
    for key in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR"):
        os.environ[key] = str(CACHE / key.lower())

    import torch

    if args.rehearse:
        tiny = load_json(HERE / "rehearse.json")
        config = dict(config, model=tiny["model"])
        if traffic["kind"] == "train":
            config["train"] = dict(config["train"], **tiny["train"])
        else:
            traffic = dict(traffic, **tiny["traffic"])
        device = torch.device("cpu")
        torch.set_num_threads(min(4, os.cpu_count() or 1))
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            fail(f"{cell['name']} needs {cell['chips']} CUDA card(s); "
                 f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", 3)
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        from i2v_adapter_tpu_torch.ops import _build

        _build.build()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def peak_bytes() -> int:
        return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    return SimpleNamespace(
        manifest=manifest, cell=cell, config=config, traffic=traffic, limits=limits, seed=args.seed,
        seconds=args.seconds, trace=bool(args.trace), device=device, rehearse=args.rehearse, t0=T0,
        sync=sync, peak_bytes=peak_bytes, log=lambda msg: print(f"portbench: {msg}", file=sys.stderr, flush=True),
        peaks=load_json(HERE / "peaks.json"))


def device_record(env, result: dict) -> dict:
    if env.device.type != "cuda":
        return {"platform": "cpu", "kind": platform.processor() or platform.machine(), "count": 1,
                "memory_peak_bytes": 0}
    import torch

    rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(env.device), "count": env.cell["chips"],
           "memory_peak_bytes": int(result["peak_bytes"])}
    if env.trace and result.get("trace") is not None:
        rec.update(busy_s=result["trace"].busy_s(), window_s=result["trace"].wall_s())
    return rec


def main(argv=None) -> int:
    args = parse_args(argv)
    env = environment(args)
    loop = importlib.import_module(f"portbench.{env.traffic['kind']}")
    result = loop.run(env)
    gc.collect()

    name = env.cell["name"]
    line = {"correct": None, "attempted": result["attempted"], "failed": result["failed"], "metrics": {}}
    if env.trace:
        from portbench import trace as tr

        ctx = dict(result["ctx"], trace=result["trace"], peaks=env.peaks, env=env)
        for metric in env.manifest["per_layer"]:
            if applies(metric, name):
                value = reader(metric["name"])(ctx)
                if value is not None:
                    line["metrics"][metric["name"]] = {"value": float(value), "unit": metric["unit"]}
        if result["trace"] is not None:
            line["breakdown"] = tr.breakdown(result["trace"])
    else:
        for metric in env.manifest["end_to_end"]:
            if applies(metric, name):
                value = result["e2e"].get(metric["name"])
                if value is None:
                    fail(f"{name} measured no {metric['name']}", 5)
                line["metrics"][metric["name"]] = {"value": float(value), "unit": metric["unit"]}
    line["device"] = device_record(env, result)

    found = forbidden_modules()
    if found:
        fail(f"modules loaded that the benchmark may not run: {', '.join(found)}", 4)
    checks = result["checks"]
    line["correct"] = result["failed"] == 0 and all(value <= limit for _, value, limit in checks)
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    for n, v, lim in checks:
        print(f"check {n} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
