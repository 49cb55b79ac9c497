"""The control of a serving cell's correctness check: the plain reference
computed one precision step below the configuration (``reference/lower.py``)
in the program's place, compared with the reference by the numbers a run
compares.  Its readings set the upper end of each limit; the program's
own readings over a dozen seeds or more set the lower end.

    python3 -m portbench.control --workload serve512_clip --seeds 11,12,13

prints one JSON line per seed, on the cell's own sizes, inputs and weights
(a serving cell: the window's first request of that seed; a training
cell: its first accumulation cycle); ``--rehearse`` runs at the tiny
sizes on the CPU.  The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from portbench import run as bench
from portbench import serve, train, weights
from portbench.reference import model as ref_model
from portbench.reference import serve as ref_serve
from portbench.reference import train as ref_train
from portbench.reference.lower import Lowered


def readings(env, seed: int) -> dict:
    """The control's numbers for ``seed``."""
    env.seed = seed
    mc = env.config["model"]
    env.tokenizer = serve.inputs.WordTokenizer(mc["text_encoder"]["vocab_size"],
                                               mc["text_encoder"]["max_position_embeddings"])
    if env.traffic["kind"] == "train":
        return train_readings(env)
    pc = env.config["pipeline"]
    dtype = getattr(torch, pc["dtype"])
    w = weights.make(weights.spec_of(ref_model.build(mc), lambda name: dtype), seed, env.device)
    req = serve.make_request(env, (serve.WINDOW, 0))
    clips = {}
    for name, prec in (("reference", None), ("control", Lowered())):
        models = ref_serve.reference_models(mc, pc, w, env.device, prec)
        clips[name] = ref_serve.clip(models, mc, pc, req, env.device)
        del models
    env.log(f"seed {seed}: frame RMS gaps {np.round(serve.frame_rms(clips['control'], clips['reference']), 2).tolist()}")
    return serve.compare(clips["control"], clips["reference"])


def train_readings(env) -> dict:
    """A training cell's control: the reference's first accumulation cycle
    with its forward in the lower precision, against the exact one."""
    mc, tcd = env.config["model"], env.config["train"]
    frozen = getattr(torch, tcd["freeze_dtype"])
    spec = weights.spec_of(ref_model.build(mc), lambda n: torch.float32 if ref_train.trainable(n, tcd) else frozen)
    w = weights.make(spec, env.seed, env.device)
    k = tcd["gradient_accumulation_steps"]
    batches = [train.make_batch(env, i) for i in range(k)]
    out = {}
    for name, prec in (("exact", ref_model.EXACT), ("control", Lowered())):
        m = ref_train.models(mc, tcd, w, env.device, prec)
        out[name] = ref_train.run(m, mc, tcd, batches, train.draw_generator(env), env.device)
        del m
    (losses, first, change), (want_losses, want_first, want_change) = out["control"], out["exact"]
    norms = {n: float(g.norm()) for n, g in want_first.items()}
    median = sorted(norms.values())[len(norms) // 2]
    return {"loss_rel_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses)),
            "first_grad_leaf_gap": train.leaf_gaps(first, want_first),
            "update_leaf_gap": train.leaf_gaps(change, want_change,
                                               lambda n: norms[n] >= train.TINY_GRAD * median)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--rehearse", action="store_true")
    args = p.parse_args(argv)
    env = bench.environment(argparse.Namespace(workload=args.workload, seed=0, seconds=0, trace=0,
                                               rehearse=args.rehearse))
    if env.device.type == "cuda":
        ref_serve.exact_fp32()
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": args.workload, "seed": seed, "control": readings(env, seed),
                          "limits": env.limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
