"""The control of the SVD cell's correctness check: the plain reference
computed one precision step below the configuration (``reference/lower.py``:
float8 e4m3 operands) in the program's place, compared with the exact
reference by the number a run compares (``frames_rms_max``).  Its readings
set the upper end of the limit; the program's own readings over a dozen
seeds or more set the lower end.

    python3 -m portbench.control_svd --workload svd_xt_clip --seeds 11,12,13

prints one JSON line per seed, on the cell's own sizes, inputs and weights
(the window's first request of that seed); ``--rehearse`` runs at the tiny
sizes on the CPU.  The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from portbench import run as bench
from portbench import serve_svd, weights
from portbench.reference import svd as ref_svd
from portbench.reference.lower import Lowered
from portbench.reference.serve import exact_fp32


def readings(env, seed: int) -> dict:
    env.seed = seed
    mc = env.config["model"]
    dtype = getattr(torch, env.config["pipeline"]["dtype"])
    w = weights.make(weights.spec_of(ref_svd.build(mc), lambda name: dtype), seed, env.device)
    req = serve_svd.make_request(env, (serve_svd.WINDOW, 0))
    clips, seconds = {}, {}
    for name, prec in (("reference", None), ("control", Lowered())):
        t0 = time.perf_counter()
        models = ref_svd.reference_models(mc, w, env.device, prec)
        clips[name] = ref_svd.clip(models, mc, req, env.device)
        del models
        seconds[name] = time.perf_counter() - t0
    (got, got_lat), (want, want_lat) = clips["control"], clips["reference"]
    gaps = serve_svd.frame_rms(got, want)
    lat_gap = float((got_lat - want_lat).norm() / want_lat.norm())
    env.log(f"seed {seed}: frame RMS gaps {np.round(gaps, 2).tolist()}, latents relative gap {lat_gap:.4f}, "
            f"seconds {seconds}")
    return {"frames_rms_max": float(gaps.max()), "latents_rel_gap": lat_gap}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--rehearse", action="store_true")
    args = p.parse_args(argv)
    env = bench.environment(argparse.Namespace(workload=args.workload, seed=0, seconds=0, trace=0,
                                               rehearse=args.rehearse))
    if args.rehearse:
        serve_svd.rehearsal_sizes(env)
    if env.device.type == "cuda":
        exact_fp32()
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": args.workload, "seed": seed, "control": readings(env, seed),
                          "limits": env.limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
