"""The control of a data-parallel training cell's correctness check
(traffic kind ``train_mesh``): the plain reference's first accumulation
cycle with its forward one precision step below the configuration
(``reference/lower.py``) in the program's place, against the exact one,
over the whole batch of every rank, compared by the numbers a run
compares.  Its readings set the upper end of each limit; the program's own
readings over the cell's seeds set the lower end.

    python3 -m portbench.control_mesh --config i2v_sd15_train --traffic batch8_accum4_dp4 --seeds 11,12,13

prints one JSON line per seed, on the configuration's sizes and the mix's
mesh, clips and weights (a cell need not name them yet).
It needs one card: each rank's clips are run in turn on it
(``train_mesh.reference_cycle``) and their terms averaged, as the ranks'
all-reduce averages them; ``--rehearse`` runs at the tiny sizes on the CPU.
The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from types import SimpleNamespace

import torch

from portbench import run as bench
from portbench import train, train_mesh, weights
from portbench.reference import model as ref_model
from portbench.reference import train as ref_train
from portbench.reference.lower import Lowered
from portbench.reference.serve import exact_fp32


def whole_batch_cycle(spec: dict, m: dict, ranks: int, dev):
    """The reference's cycle over every rank's clips: the losses, the first
    gradient and the first update's change of the whole batch."""
    tcd = spec["config"]["train"]
    per = tcd["train_batch_size"]
    global_tc = dict(tcd, train_batch_size=per * ranks)
    losses, first, acc = None, None, None
    for r in range(ranks):
        got = train_mesh.reference_cycle(spec, m, (r * per, (r + 1) * per), global_tc, dev, lambda flat: flat / ranks)
        if losses is None:
            losses, first, acc = got
            continue
        losses = [a + b for a, b in zip(losses, got[0])]
        for total, part in ((first, got[1]), (acc, got[2])):
            for n, g in part.items():
                total[n] += g
    params = {n: p.detach() for n, p in m["unet"].named_parameters() if p.requires_grad}
    return losses, first, ref_train.adamw_first_update(acc, params, tcd)


def readings(env, seed: int) -> dict:
    mesh = env.traffic["mesh"]
    if any(v != 1 for axis, v in mesh.items() if axis != "data"):
        raise ValueError("the control splits clips over data ranks only, as train_mesh runs them")
    mcd, tcd = env.config["model"], env.config["train"]
    spec = {"config": env.config, "traffic": env.traffic, "seed": seed}
    frozen = getattr(torch, tcd["freeze_dtype"])
    w = weights.make(weights.spec_of(ref_model.build(mcd),
                                     lambda n: torch.float32 if ref_train.trainable(n, tcd) else frozen),
                     seed, env.device)
    out, seconds = {}, {}
    for name, prec in (("exact", ref_model.EXACT), ("control", Lowered())):
        t0 = time.perf_counter()
        m = ref_train.models(mcd, tcd, w, env.device, prec)
        out[name] = whole_batch_cycle(spec, m, math.prod(mesh.values()), env.device)
        del m
        seconds[name] = time.perf_counter() - t0
    (losses, first, change), (want_losses, want_first, want_change) = out["control"], out["exact"]
    norms = {n: float(g.norm()) for n, g in want_first.items()}
    median = sorted(norms.values())[len(norms) // 2]
    env.log(f"seed {seed}: losses {losses} against {want_losses}, seconds {seconds}")
    return {"loss_rel_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses)),
            "first_grad_leaf_gap": train.leaf_gaps(first, want_first),
            "update_leaf_gap": train.leaf_gaps(change, want_change,
                                               lambda n: norms[n] >= train.TINY_GRAD * median)}


def environment(config: str, traffic: str, rehearse: bool) -> SimpleNamespace:
    """A ``train_mesh`` mix's files and one device: the card, or the CPU at
    the tiny sizes."""
    mix = bench.load_json(bench.HERE / "traffic" / f"{traffic}.json")
    if mix["kind"] != "train_mesh":
        bench.fail(f"{traffic} is not a train_mesh mix")
    cfg = bench.load_json(bench.HERE / "configs" / f"{config}.json")
    if rehearse:
        tiny = bench.load_json(bench.HERE / "rehearse.json")
        cfg = dict(cfg, model=tiny["model"], train=dict(cfg["train"], **tiny["train"]))
    elif not torch.cuda.is_available():
        bench.fail("the control needs a CUDA card (or --rehearse)", 3)
    return SimpleNamespace(config=cfg, traffic=mix, device=torch.device("cpu" if rehearse else "cuda"),
                           log=lambda msg: print(f"portbench: {msg}", file=sys.stderr, flush=True))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--rehearse", action="store_true")
    args = p.parse_args(argv)
    env = environment(args.config, args.traffic, args.rehearse)
    if env.device.type == "cuda":
        exact_fp32()
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"config": args.config, "traffic": args.traffic, "seed": seed,
                          "control": readings(env, seed)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
