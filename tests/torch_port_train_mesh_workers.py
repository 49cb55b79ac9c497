"""Rank workers of ``tests/test_torch_port_train_mesh.py``.

Each function runs on every rank of a gloo group that
``i2v_adapter_tpu_torch.parallel.launch.run_ranks`` spawned on the CPU.  A
spawned process imports the module that holds its target, so this one
imports no JAX: the test feeds numpy inputs (the JAX package's parameter
trees, batches and draws) in and holds the results against the JAX package
in its own process.
"""

from __future__ import annotations

import os
import pickle
import random
import time

import numpy as np
import torch
import torch.distributed as dist

from i2v_adapter_tpu_torch.config import I2VModelConfig, MeshConfig, TrainConfig
from i2v_adapter_tpu_torch.parallel import collectives
from i2v_adapter_tpu_torch.parallel.mesh import (
    SEQ_AXIS,
    TENSOR_AXIS,
    create_mesh,
    local_batch,
    train_state_shardings,
)

# the train step's meshes: (data, fsdp, tensor, seq), fsdp_frozen
STEP_MESHES = {
    "4,1,1,1": ((4, 1, 1, 1), "shard"),
    "2,2,1,1": ((2, 2, 1, 1), "shard"),
    "2,1,1,2": ((2, 1, 1, 2), "shard"),
    "1,2,1,2/replicate": ((1, 2, 1, 2), "replicate"),
    "1,1,2,2": ((1, 1, 2, 2), "shard"),
}
# the mesh the snr_gamma / first_frame_mode='exact' step runs at
SNR_MESH = "2,1,1,2"
# the fsdp threshold the tiny state is placed with (its leaves are all
# below the production 2^16, as tests/test_training.py lowers it)
MIN_SIZE = 1024


def _mesh(sizes) -> object:
    return create_mesh(MeshConfig(*sizes), device="cpu")


def _gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    return collectives.all_gather(x.detach().contiguous(), 0, group)


# ---------------------------------------------------------------------------
# each collective's gradient
# ---------------------------------------------------------------------------


def collective_grads(inputs: dict) -> dict:
    """Every rank's gradient of its loss term through each collective, the
    ranks' gradients concatenated (rank-major) or, where the input is
    replicated, rank 0's; over a 4-rank ``seq`` group (``tensor`` for the
    Megatron pair).  ``inputs`` are numpy: ``x`` (4*2, 3, 5) split by rows,
    ``w`` (4, 8, 3, 5) each rank's weights on the whole, ``t`` (2, 4, 8, 6)
    and ``wt`` (4, 2, 4, 8, 6) a (B, F, S, C) tensor and weights for the
    all-to-all pair, ``a`` (4, 5, 7) each rank's column block of a
    projection."""
    t = {k: torch.from_numpy(v).double() for k, v in inputs.items()}
    seq = _mesh((1, 1, 1, 4))
    r, g = seq.index(SEQ_AXIS), seq.group(SEQ_AXIS)
    out = {}

    def leaf(x):
        return x.clone().requires_grad_(True)

    # all-gather: each rank's block of x; the loss sum(w_r * whole)
    x = leaf(t["x"][2 * r:2 * r + 2])
    (t["w"][r] * collectives.all_gather(x, 0, g)).sum().backward()
    out["all_gather"] = _gather_rows(x.grad, g)
    # the all-to-all pair: frames split -> tokens split, tanh, frames back;
    # the loss sum(w_r * frames-split output), and the single trade's
    # loss sum(w_r * tokens-split slab)
    x = leaf(t["t"][:, r:r + 1])
    y = collectives.all_to_all(torch.tanh(collectives.all_to_all(x, 2, 1, g)), 1, 2, g)
    (t["wt"][r][:, r:r + 1] * y).sum().backward()
    out["all_to_all_pair"] = collectives.all_gather(x.grad, 1, g)
    x = leaf(t["t"][:, r:r + 1])
    (t["wt"][r][:, :, 2 * r:2 * r + 2] * collectives.all_to_all(x, 2, 1, g)).sum().backward()
    out["all_to_all"] = collectives.all_gather(x.grad, 1, g)
    # SUM all-reduce over the split axis: column sums of the whole x
    x = leaf(t["x"][2 * r:2 * r + 2])
    (t["w"][r][0] * collectives.all_reduce(x.sum(0), "sum", g)).sum().backward()
    out["all_reduce"] = _gather_rows(x.grad, g)
    # broadcast from seq rank 0 (every rank passes its own x block)
    x = leaf(t["x"][2 * r:2 * r + 2])
    (t["w"][r][:2] * collectives.broadcast(x, 0, g)).sum().backward()
    out["broadcast"] = _gather_rows(x.grad, g)

    tp = _mesh((1, 1, 4, 1))
    r, g = tp.index(TENSOR_AXIS), tp.group(TENSOR_AXIS)
    # Megatron's g: partial products summed forward, identity backward;
    # the loss (replicated over tensor) counted once
    p = leaf(t["x"][2 * r:2 * r + 2])
    (t["w"][0][:2] * collectives.reduce_from_parallel(p, g)).sum().backward()
    out["reduce_from_parallel"] = _gather_rows(p.grad, g)
    # Megatron's f: a replicated input into each rank's column block
    x = leaf(t["x"][:2])
    h = collectives.copy_to_parallel(x, g) @ t["a"][r]
    (t["w"][r][:2, :, :1].expand(2, 3, 7) * h).sum().backward()
    out["copy_to_parallel"] = x.grad.clone()
    with torch.no_grad():  # the MAX all-reduce carries no gradient
        out["max_forward"] = collectives.all_reduce(t["x"][r].clone(), "max", g)
    try:
        collectives.all_reduce(leaf(t["x"][r]), "max", g).sum().backward()
        out["max_backward_raised"] = False
    except RuntimeError:
        out["max_backward_raised"] = True
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in out.items()}


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _models(model_cfg: I2VModelConfig, params: dict):
    from i2v_adapter_tpu_torch.models import AutoencoderKL, CLIPTextEncoder, CLIPVisionEncoder, VideoUNet
    from i2v_adapter_tpu_torch.utils.convert import load_flax_params

    return (load_flax_params(VideoUNet(model_cfg.unet, device="cpu"), params["unet"]),
            load_flax_params(AutoencoderKL(model_cfg.vae, device="cpu"), params["vae"]),
            load_flax_params(CLIPTextEncoder(model_cfg.text_encoder, device="cpu"), params["text_encoder"]),
            load_flax_params(CLIPVisionEncoder(model_cfg.image_encoder, device="cpu"), params["image_encoder"]))


def _state(model_cfg, tc, params, mesh=None, min_size=MIN_SIZE):
    from i2v_adapter_tpu_torch.training import create_train_state

    unet, vae, text, image = _models(model_cfg, params)
    state = create_train_state(unet, tc, 10, vae, text, image)
    if mesh is not None:
        from i2v_adapter_tpu_torch.parallel.zero import place_train_state

        place_train_state(state, mesh, train_state_shardings(state, mesh, min_size, tc.fsdp_frozen == "replicate"))
    return state


def _flax_grads(state, grads: dict) -> dict:
    """Whole gradients (blocks gathered) under their ``/``-joined Flax
    names, in the Flax layout."""
    from i2v_adapter_tpu_torch.utils.convert import flax_leaf

    modules = dict(state.unet.named_modules())
    out = {}
    names = {param: name for name, _, _, _, param in _entries(state) if name.startswith("trainable/")}
    for n, g in grads.items():
        if state.zero is not None:
            g = state.zero.gather(names[n], g)
        path, perm = flax_leaf(modules, n)
        out["/".join(path)] = (g.permute(perm) if perm is not None else g).detach().numpy().copy()
    return out


def _entries(state):
    from i2v_adapter_tpu_torch.training.checkpoint import state_entries

    return state_entries(state)


def _whole_state(state) -> dict:
    """The whole state (blocks gathered) by name, numpy; every rank calls."""
    from i2v_adapter_tpu_torch.training.checkpoint import train_state_tensors

    tensors = state.zero.full_tensors(state) if state.zero is not None else train_state_tensors(state)
    return {k: v.detach().numpy().copy() for k, v in tensors.items()}


def compare_states(got: dict, want: dict, start: dict) -> dict:
    """Per tensor of ``want`` (whole states by name, numpy): whether
    ``got`` has it at its shape, ``max |got - want|`` and the scale the
    test's tolerance is taken of (the largest update from ``start`` for the
    trainables and the EMA, the largest value for the rest); the states
    stay in the ranks, only these numbers travel."""
    out = {"names_equal": set(got) == set(want)}
    for name, w in want.items():
        g = got.get(name)
        if g is None or g.shape != w.shape:
            out[name] = (False, float("inf"), 0.0)
            continue
        moved = name.split("/")[0] in ("trainable", "ema")
        scale = float(np.max(np.abs(w - start[name]))) if moved else float(np.max(np.abs(w)))
        out[name] = (True, float(np.max(np.abs(g.astype(np.float64) - w.astype(np.float64)))), scale)
    return out


def unequal(got: dict, want: dict) -> list:
    """The names whose tensors differ in any bit (or are missing)."""
    return sorted(n for n in set(got) | set(want)
                  if n not in got or n not in want or not np.array_equal(got[n], want[n]))


def step_grads(model_cfg: I2VModelConfig, cases: dict, params: dict, batch: dict) -> dict:
    """Per case (``{name: (train config dict, draws)}``) and mesh of
    ``STEP_MESHES``: the meshed step's global loss and its gathered
    trainable gradients (``loss_and_grads``), and one step's recorded
    collectives with the formula's inputs."""
    from i2v_adapter_tpu_torch.training import make_train_step

    out = {}
    for case, (tc_dict, draws) in cases.items():
        tc = TrainConfig.from_dict(tc_dict)
        for name, (sizes, frozen) in STEP_MESHES.items():
            if case != "base" and name != SNR_MESH:
                continue  # snr_gamma / first_frame_mode act across frames: a seq mesh
            mesh = _mesh(sizes)
            tcm = tc.replace(fsdp_frozen=frozen, mesh=MeshConfig(*sizes))
            state = _state(model_cfg, tcm, params, mesh)
            step = make_train_step(model_cfg, tcm, mesh=mesh)
            with collectives.recording() as ops:
                loss, grads = step.loss_and_grads(state, local_batch(batch, mesh), draws)
            out[f"{case}/{name}"] = {
                "loss": float(loss), "grads": _flax_grads(state, grads),
                "counts": {k: sum(1 for op in ops if op.kind == k) for k in {op.kind for op in ops}},
                "zero": state.zero.counts(state), "split": _split_leaves(state),
            }
    return out


def _split_leaves(state) -> int:
    """How many of the state's tensors this rank holds a block of, each
    equal to its slice of the whole (checked: raises otherwise)."""
    from i2v_adapter_tpu_torch.training.checkpoint import train_state_tensors

    whole = state.zero.full_tensors(state)
    live = train_state_tensors(state)
    n = 0
    for name in state.zero.dims:
        d, axis = state.zero.spec_axis(state.zero.specs[name])
        assert live[name].shape != whole[name].shape, name
        assert torch.equal(live[name], state.zero.block(whole[name], d, axis)), name
        n += 1
    return n


def two_steps(model_cfg: I2VModelConfig, params: dict, batch: dict, tc_dict: dict, sizes, ckpt_dir: str,
              min_size: int = MIN_SIZE) -> dict:
    """Two steps of the port unmeshed and over ``sizes`` (default draws from
    the step's generator, the same global numbers): the whole states after
    them.  Then, over the mesh, a full-state save restored by an unmeshed
    state, and the unmeshed state's save restored over the mesh."""
    from i2v_adapter_tpu_torch.training import make_train_step
    from i2v_adapter_tpu_torch.training.checkpoint import TrainCheckpointer

    tc = TrainConfig.from_dict(tc_dict)
    mesh = _mesh(sizes)
    one = _state(model_cfg, tc, params)
    start = _whole_state(one)
    step = make_train_step(model_cfg, tc, device="cpu")
    for _ in range(2):
        one, _ = step(one, batch)
    meshed = _state(model_cfg, tc.replace(mesh=MeshConfig(*sizes)), params, mesh, min_size)
    mstep = make_train_step(model_cfg, tc, mesh=mesh)
    losses = []
    for _ in range(2):
        meshed, m = mstep(meshed, local_batch(batch, mesh))
        losses.append(float(m["loss"]))
    whole_one, whole_meshed = _whole_state(one), _whole_state(meshed)
    out = {"close": compare_states(whole_meshed, whole_one, start), "losses": losses,
           "split": _split_leaves(meshed)}
    # a meshed save, restored by one process; the unmeshed save, restored
    # over the mesh
    meshed_dir, one_dir = os.path.join(ckpt_dir, "meshed"), os.path.join(ckpt_dir, "one")
    TrainCheckpointer(meshed_dir).save(2, meshed)
    if mesh.rank == 0:
        TrainCheckpointer(one_dir).save(2, one)
    dist.barrier(group=mesh.control)
    fresh = _state(model_cfg, tc, params)
    TrainCheckpointer(meshed_dir).restore(fresh)
    out["restored_by_one_unequal"] = unequal(_whole_state(fresh), whole_meshed)
    fresh = _state(model_cfg, tc.replace(mesh=MeshConfig(*sizes)), params, mesh, min_size)
    TrainCheckpointer(one_dir).restore(fresh)
    out["restored_over_mesh_unequal"] = unequal(_whole_state(fresh), whole_one)
    out["counters"] = (fresh.step, fresh.opt_state.count, fresh.opt_state.mini_step)
    return out


def bench(argv: list) -> list:
    """``--bench_scaling``'s records over this spawn's ranks (the driver's
    rank function, without its own spawn)."""
    from i2v_adapter_tpu_torch.training import driver

    args = driver.parse_args(argv)
    return driver._bench_rank(args, None, driver.bench_shapes(args.bench_mesh_shapes, dist.get_world_size()))


class SharedDraws:
    """Items that draw from one shared ``random.Random``, as
    ``WebVidDataset``'s do (a window start, then a flip), with a pause of
    random length between the draws so that a loader's threads take them
    in no fixed order."""

    def __init__(self, n: int):
        self.n, self.rng, self.pause = n, random.Random(0), random.SystemRandom()

    def __len__(self) -> int:
        return self.n

    def skip(self, idx: int) -> None:
        self.rng.randint(0, 99)
        self.rng.random()

    def __getitem__(self, idx: int) -> dict:
        start = self.rng.randint(0, 99)
        time.sleep(self.pause.random() * 2e-3)
        return {"pixel_values": np.array([idx, start, int(self.rng.random() < 0.5)])}


def block_batches(meshes: list, clips: int = 16, batch: int = 4) -> dict:
    """Each mesh's epoch of ``driver.block_batches`` over a 4-thread
    loader of ``SharedDraws``, on every rank: ``(the rank's block, its
    batches)`` per rank, and the loader's global order of indices."""
    from i2v_adapter_tpu_torch.data.loader import DataLoader
    from i2v_adapter_tpu_torch.parallel.mesh import CLIP_AXES, batch_rows
    from i2v_adapter_tpu_torch.training.driver import block_batches as batches_of

    out = {}
    for sizes in meshes:
        mesh = _mesh(sizes)
        loader = DataLoader(SharedDraws(clips), batch, num_workers=4, seed=1, rows=batch_rows(mesh, batch))
        mine = [b["pixel_values"].tolist() for b in batches_of(loader, mesh)]
        seen = [None] * dist.get_world_size()
        dist.all_gather_object(seen, (mesh.index(CLIP_AXES), mine), group=mesh.control)
        out[",".join(map(str, sizes))] = seen
    order = np.arange(clips)
    np.random.default_rng(1).shuffle(order)
    out["order"] = order.tolist()
    return out


def all_checks(collective_inputs: dict, params_path: str, cases: dict, batch: dict, two_step: dict,
               adafactor: dict, ckpt_dir: str, bench_argv: list) -> dict:
    """Every check of the test module in one spawn of 4 ranks; rank 0
    returns every result, the others their collectives' (held equal to
    rank 0's)."""
    from i2v_adapter_tpu_torch.config import tiny_test_config

    with open(params_path, "rb") as f:
        params = pickle.load(f)
    model_cfg = I2VModelConfig.from_dict(params["config"])
    out = {"collectives": collective_grads(collective_inputs),
           "steps": step_grads(model_cfg, cases, params, batch)}
    for name, spec in two_step.items():
        out[name] = two_steps(model_cfg, params, batch, spec["tc"], spec["mesh"], os.path.join(ckpt_dir, name))
    # Adafactor on factored leaves: 128-wide blocks, the motion modules
    # trained too, seeded port weights
    wide = tiny_test_config()
    wide = wide.replace(unet=wide.unet.replace(block_out_channels=(128, 128), flash_attention=False,
                                               fast_gelu=False, flash_static_max=0.0))
    out["adafactor"] = _adafactor(wide, adafactor, batch)
    out["bench"] = bench(bench_argv)
    out["block_batches"] = block_batches([(2, 1, 1, 2), (1, 1, 2, 2), (2, 2, 1, 1)])
    return out if dist.get_rank() == 0 else {"collectives": out["collectives"]}


def _adafactor(model_cfg, spec: dict, batch: dict) -> dict:
    from i2v_adapter_tpu_torch.training import make_train_step
    from i2v_adapter_tpu_torch.utils.random_init import random_train_state

    tc = TrainConfig.from_dict(spec["tc"])
    batch = dict({k: v[:tc.train_batch_size] for k, v in batch.items()},
                 pixel_values=batch["pixel_values"][:tc.train_batch_size, :tc.num_frames])
    mesh = _mesh(spec["mesh"])
    one = random_train_state(model_cfg, tc, "cpu", seed=3)
    start = _whole_state(one)
    step = make_train_step(model_cfg, tc, device="cpu")
    meshed = random_train_state(model_cfg, tc, "cpu", seed=3)
    from i2v_adapter_tpu_torch.parallel.zero import place_train_state

    place_train_state(meshed, mesh, train_state_shardings(meshed, mesh, spec["min_size"]))
    mstep = make_train_step(model_cfg, tc, mesh=mesh)
    factored = sum(1 for n, _, _, _, _ in _entries(meshed) if n.startswith("opt_state/v_row/"))
    for _ in range(2):
        one, _ = step(one, batch)
        meshed, _ = mstep(meshed, local_batch(batch, mesh))
    return {"close": compare_states(_whole_state(meshed), _whole_state(one), start), "factored": factored,
            "split": _split_leaves(meshed)}
