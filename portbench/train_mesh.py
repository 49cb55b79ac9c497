"""The data-parallel training loop: ``train.py``'s back-to-back micro-steps
on each rank of a mesh, one process per card (``parallel.launch.run_ranks``;
under ``--rehearse`` gloo ranks on the CPU at ``rehearse.json``'s sizes).

Each rank holds ``train_batch_size`` clips of every micro-step (the
configuration's per-card batch), so a micro-step trains that times
``data`` clips (a data-parallel mesh only: every rank holds the whole
trainables, which the check compares); clip i of micro-step k is drawn
from the run's seed and (k, i) alone, so each rank makes only its own.  Every rank draws the
global batch's noise, timesteps and dropout from one generator seeded as
``train.py``'s and keeps its rows (``make_train_step(..., mesh=...)``).
Set-up: weights made on each card from the seed, the state placed over the
mesh, the staged batches, one whole accumulation cycle.  The window runs
whole accumulation cycles; after each, rank 0's host clock decides whether
the window has closed and tells the others (a gloo broadcast), so every
rank runs the same micro-steps.  ``train_clips_per_s`` counts every rank's
clips over rank 0's window, synchronised at its two ends; ``peak_mem_gib``
is the largest rank's.  With ``--trace 1`` one more micro-step runs, on
rank 0 under the profiler.

The check: after the window each rank frees the program and runs the
plain reference (``reference/train.py``) on its own clips of the set-up's
accumulation cycle, in fp32 on its card, from the global draws; the
losses and gradients (each over its rank's clips, normalised by its
clips) are summed over the ranks and divided by the ranks, which gives
the whole batch's; rank 0 compares them and the first update with the
program's as ``train.py`` does.  Besides, ``rank_param_gap``: the largest
gap of any rank's trainables from rank 0's after that cycle; the ranks
apply one summed gradient, so a sound run reads 0 and a rank that steps on
its own clips, or drifts, reads above it.
"""

from __future__ import annotations

import gc
import json
import time
from pathlib import Path

import numpy as np
import torch

from portbench import inputs, spans, trace, train, weights
from portbench.reference import model as ref_model
from portbench.reference import train as ref_train

HERE = Path(__file__).resolve().parent
STAGED = 8
# generator keys of the run's seed: train.py's, and a clip of a micro-step
BATCH, DRAWS = train.BATCH, train.DRAWS
# how long the ranks may take, set-up and reference included, before the
# run is ended (a rank that hangs in a collective ends it here)
RANKS_TIMEOUT_S = 1200


def clip_rows(spec: dict, k: int, rows) -> dict:
    """Clips ``rows`` of micro-step ``k``: pixels uniform in [-1, 1], prompt
    ids, the unconditional ids, CLIP images; numpy."""
    mc, tc = spec["config"]["model"], spec["config"]["train"]
    f, r, s = tc["num_frames"], tc["resolution"], mc["image_encoder"]["image_size"]
    tok = inputs.WordTokenizer(mc["text_encoder"]["vocab_size"], mc["text_encoder"]["max_position_embeddings"])
    out = {"pixel_values": [], "text_ids": [], "uncond_ids": [], "clip_image": []}
    for i in range(*rows):
        g = inputs.rng(spec["seed"], BATCH, k, i)
        out["pixel_values"].append(g.random((f, r, r, 3), dtype=np.float32) * 2 - 1)
        out["text_ids"].append(tok([inputs.prompt(g, spec["traffic"]["prompt_words"], tok.vocab_size)])[0])
        out["uncond_ids"].append(tok([""])[0])
        out["clip_image"].append(g.standard_normal((s, s, 3), dtype=np.float32))
    return {k2: np.stack(v).astype(np.int64 if k2.endswith("ids") else np.float32) for k2, v in out.items()}


def _to(batch: dict, dev) -> dict:
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def rank_param_gap(params: dict) -> float:
    """The largest absolute gap of this rank's trainables from rank 0's,
    the worst over the ranks (every rank gets it)."""
    import torch.distributed as dist

    mine = torch.cat([p.detach().reshape(-1).float() for p in params.values()])
    lead = mine.clone()
    dist.broadcast(lead, 0)
    gap = (mine - lead).abs().max().reshape(1)
    dist.all_reduce(gap, op=dist.ReduceOp.MAX)
    return float(gap)


def _rank(spec: dict) -> dict:
    """One rank's run: set-up, window, traced micro-step, reference."""
    import torch.distributed as dist

    from i2v_adapter_tpu_torch.config import I2VModelConfig, MeshConfig, TrainConfig
    from i2v_adapter_tpu_torch.models import AutoencoderKL, CLIPTextEncoder, CLIPVisionEncoder, VideoUNet
    from i2v_adapter_tpu_torch.parallel.mesh import CLIP_AXES, batch_rows, create_mesh
    from i2v_adapter_tpu_torch.training import create_train_state, make_train_step

    mcd, tcd = spec["config"]["model"], spec["config"]["train"]
    mesh_cfg = MeshConfig(**spec["traffic"]["mesh"])
    mesh = create_mesh(mesh_cfg, device=spec["device"])
    dev, rank = mesh.device, mesh.rank
    ways = mesh.size(CLIP_AXES)
    global_tc = dict(tcd, train_batch_size=tcd["train_batch_size"] * ways, mesh=spec["traffic"]["mesh"])
    mc, tc = I2VModelConfig.from_dict(mcd), TrainConfig.from_dict(global_tc)
    frozen = getattr(torch, tcd["freeze_dtype"])
    w = weights.make(weights.spec_of(ref_model.build(mcd),
                                     lambda n: torch.float32 if ref_train.trainable(n, tcd) else frozen),
                     spec["seed"], dev)
    modules = {"unet": VideoUNet(mc.unet, device="meta"), "vae": AutoencoderKL(mc.vae, device="meta"),
               "text_encoder": CLIPTextEncoder(mc.text_encoder, device="meta"),
               "image_encoder": CLIPVisionEncoder(mc.image_encoder, device="meta")}
    weights.load(modules, {k: v.clone() if ref_train.trainable(k, tcd) else v for k, v in w.items()})
    state = create_train_state(modules["unet"], tc, 10 ** 6, vae=modules["vae"], text_encoder=modules["text_encoder"],
                               image_encoder=modules["image_encoder"], mesh=mesh)
    step_fn = make_train_step(mc, tc, mesh=mesh)
    rows = batch_rows(mesh, global_tc["train_batch_size"])
    batches = [_to(clip_rows(spec, k, rows), dev) for k in range(STAGED)]
    k = tcd["gradient_accumulation_steps"]
    gen = torch.Generator(device=dev).manual_seed(int(inputs.rng(spec["seed"], DRAWS).integers(0, 2 ** 63 - 1)))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dist.barrier(group=mesh.control)

    losses, first = [], None
    for i in range(k):
        state, metrics = step_fn(state, batches[i], generator=gen)
        losses.append(float(metrics["loss"]))
        if i == 0:
            first = {n: a.detach().clone() for n, a in state.opt_state.acc.items()}
    changed = {n: p.detach().float() - w[f"unet.{n}"].float() for n, p in state.trainable_params().items()}
    rank_gap = rank_param_gap(state.trainable_params())
    sync()
    setup_s = time.time() - spec["t0_wall"]

    steps, flag = 0, torch.zeros(1)
    start = time.perf_counter()
    while True:
        for _ in range(k):
            step_fn(state, batches[(k + steps) % STAGED], generator=gen)
            steps += 1
        flag[0] = float(time.perf_counter() - start >= spec["seconds"])
        dist.broadcast(flag, 0, group=mesh.control)
        if flag[0]:
            break
    sync()
    window_s = time.perf_counter() - start
    grad_sync_ms = spans.mean_per_unit(spans.window_micro_steps(), "grad_sync", spans.device_ms)
    traced = None
    if spec["trace"]:
        batch = batches[(k + steps) % STAGED]
        if rank == 0:
            _, traced = trace.record(lambda: step_fn(state, batch, generator=gen), "micro_step")
        else:
            step_fn(state, batch, generator=gen)
        sync()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    del state, step_fn, batches, modules
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = check(spec, mesh, rows, global_tc, w, losses, first, changed, rank_gap)
    return {"rank": rank, "setup_s": setup_s, "steps": steps, "window_s": window_s, "peak_bytes": peak,
            "trace": traced, "grad_sync_ms": grad_sync_ms, "checks": checks, "losses": losses,
            "reference_s": time.perf_counter() - t_ref, "clips_per_step": global_tc["train_batch_size"]}


def reference_cycle(spec, m, rows, global_tc, dev, reduce):
    """The reference's accumulation cycle over clips ``rows`` of each
    micro-step, from the global draws: per micro-step the loss and the
    gradients of those clips (normalised by their count) as one fp64
    vector, which ``reduce`` makes the whole batch's (over a mesh: the mean
    over the ranks).  Returns the losses, the first gradient and the mean
    gradient of the cycle."""
    mcd, tcd = spec["config"]["model"], spec["config"]["train"]
    gen = torch.Generator(device=dev).manual_seed(int(inputs.rng(spec["seed"], DRAWS).integers(0, 2 ** 63 - 1)))
    f, (r0, r1) = tcd["num_frames"], rows
    losses, acc, first = [], None, None
    for i in range(tcd["gradient_accumulation_steps"]):
        d = ref_train.draws(mcd, global_tc, gen, dev)
        local = {"posterior_noise": d["posterior_noise"][r0 * f:r1 * f], "timesteps": d["timesteps"][r0:r1],
                 "drop_uniform": d["drop_uniform"][r0:r1], "noise": d["noise"][r0:r1]}
        loss, grads = ref_train.loss_and_grads(m, mcd, tcd, _to(clip_rows(spec, i, rows), dev), local)
        names = list(grads)
        flat = reduce(torch.cat([torch.tensor([loss], device=dev, dtype=torch.float64)]
                                + [grads[n].reshape(-1).double() for n in names]))
        losses.append(float(flat[0]))
        total, offset = {}, 1
        for n in names:
            size = grads[n].numel()
            total[n] = flat[offset:offset + size].view(grads[n].shape).float()
            offset += size
        if first is None:
            first = {n: g.clone() for n, g in total.items()}
            acc = {n: torch.zeros_like(g) for n, g in total.items()}
        for n, g in total.items():
            acc[n] += (g - acc[n]) / (i + 1)
    return losses, first, acc


def check(spec, mesh, rows, global_tc, w, losses, first, changed, rank_gap) -> list:
    """The reference over this rank's clips, averaged over the ranks; rank
    0's comparison (``train.check``'s numbers and ``rank_param_gap``), the
    others' empty."""
    import torch.distributed as dist

    mcd, tcd = spec["config"]["model"], spec["config"]["train"]
    dev, world = mesh.device, dist.get_world_size()
    if dev.type == "cuda":
        from portbench.reference.serve import exact_fp32

        exact_fp32()
    m = ref_train.models(mcd, tcd, w, dev)

    def mean_over_ranks(flat):
        dist.all_reduce(flat)
        return flat / world

    want_losses, want_first, acc = reference_cycle(spec, m, rows, global_tc, dev, mean_over_ranks)
    params = {n: p.detach() for n, p in m["unet"].named_parameters() if p.requires_grad}
    want_change = ref_train.adamw_first_update(acc, params, tcd)
    if mesh.rank != 0:
        return []
    norms = {n: float(g.norm()) for n, g in want_first.items()}
    median = float(np.median(list(norms.values())))
    limits = spec["limits"]
    return [("loss_rel_gap", max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses)), limits["loss_rel_gap"]),
            ("first_grad_leaf_gap", train.leaf_gaps(first, want_first), limits["first_grad_leaf_gap"]),
            ("update_leaf_gap", train.leaf_gaps(changed, want_change, lambda n: norms[n] >= train.TINY_GRAD * median),
             limits["update_leaf_gap"]),
            ("rank_param_gap", rank_gap, limits["rank_param_gap"])]


def run(env) -> dict:
    from i2v_adapter_tpu_torch.parallel.launch import run_ranks

    config = env.config
    if env.rehearse:
        tiny = json.loads((HERE / "rehearse.json").read_text())
        config = dict(config, train=dict(config["train"], **tiny["train"]))
    if any(v != 1 for axis, v in env.traffic["mesh"].items() if axis != "data"):
        raise ValueError("train_mesh runs a data-parallel mesh only (fsdp, tensor and seq 1)")
    ranks = int(np.prod(list(env.traffic["mesh"].values())))
    spec = {"config": config, "traffic": env.traffic, "limits": env.limits, "seed": env.seed, "seconds": env.seconds,
            "trace": env.trace, "device": "cpu" if env.rehearse else None,
            "t0_wall": time.time() - (time.perf_counter() - env.t0)}
    results = sorted(run_ranks(_rank, ranks, (spec,), spec["device"], timeout=RANKS_TIMEOUT_S), key=lambda r: r["rank"])
    lead = results[0]
    env.log(f"set-up {lead['setup_s']:.1f} s, {lead['steps']} micro-steps of {lead['clips_per_step']} clips in "
            f"{lead['window_s']:.1f} s on {ranks} ranks, reference {lead['reference_s']:.1f} s, losses "
            f"{lead['losses']}; peak GiB by rank {[round(r['peak_bytes'] / 2 ** 30, 2) for r in results]}")
    steps, window_s = lead["steps"], lead["window_s"]
    peak = max(r["peak_bytes"] for r in results)
    return {
        "attempted": steps + (1 if env.trace else 0), "failed": 0, "checks": lead["checks"], "peak_bytes": peak,
        "trace": lead["trace"],
        "e2e": {"train_clips_per_s": steps * lead["clips_per_step"] / window_s, "setup_s": lead["setup_s"],
                "peak_mem_gib": peak / 2 ** 30},
        "ctx": {"unit_s": window_s / steps, "traced_units": 1, "steps": 1, "grad_sync_ms": lead["grad_sync_ms"]},
    }
