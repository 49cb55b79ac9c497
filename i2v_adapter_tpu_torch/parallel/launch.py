"""One process per rank: spawn the ranks of a mesh, or join ``torchrun``'s.

``run_ranks(fn, n, args, device)`` starts ``n`` processes (the ``spawn``
start method), each joining one group (NCCL on the cards, gloo with
``device="cpu"``) at a ``file://`` rendezvous of its own and calling
``fn(*args)``; it returns every rank's result in rank order.  A rank that
raises, dies or outlives ``timeout`` ends the run: the others are
terminated and ``RuntimeError`` carries the rank's traceback, so no rank is
left waiting in a collective.  ``run_meshed`` is the ``--mesh`` entry of the
CLI and the daemon (the training driver spawns its ranks the same way):
under ``torchrun`` (``RANK`` / ``WORLD_SIZE`` set) this
process joins the group and runs its rank; run alone it spawns one rank per
card of the mesh.  ``fn`` and its arguments are pickled by reference, so
``fn`` lives in a module the ranks can import.
"""

from __future__ import annotations

import os
import queue as queue_lib
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import torch

from i2v_adapter_tpu_torch.config import MeshConfig
from i2v_adapter_tpu_torch.device import DeviceLike


def _rank_entry(rank: int, world: int, init_method: str, device, fn, args, results) -> None:
    import torch.distributed as dist

    from i2v_adapter_tpu_torch.parallel.mesh import init_distributed

    if device is not None and torch.device(device).type == "cpu":
        torch.set_num_threads(1)  # several ranks share the host's cores
    try:
        init_distributed(rank, world, init_method, device)
        value = fn(*args)
        results.put((rank, True, value))
    except BaseException:  # noqa: BLE001 -- reported to the parent, which ends the run
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, args: Sequence = (), device: DeviceLike = None,
              timeout: Optional[float] = None) -> list:
    """``fn(*args)`` on each of ``world`` spawned ranks; their results in
    rank order.  Raises ``RuntimeError`` when a rank fails or the run
    outlives ``timeout`` seconds (every rank is stopped first)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    rendezvous = tempfile.mkdtemp(prefix="i2v_mesh_")
    init_method = "file://" + os.path.join(rendezvous, "init")
    procs = [ctx.Process(target=_rank_entry, args=(r, world, init_method, device, fn, tuple(args), results))
             for r in range(world)]
    deadline = None if timeout is None else time.monotonic() + timeout
    got: dict = {}
    try:
        for p in procs:
            p.start()
        while len(got) < world:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs) if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"mesh rank {dead[0]} died with exit code {procs[dead[0]].exitcode}")
                if deadline is not None and time.monotonic() > deadline:
                    raise RuntimeError(f"mesh ranks {sorted(set(range(world)) - set(got))} still running "
                                       f"after {timeout:.0f} s")
                continue
            if not ok:
                raise RuntimeError(f"mesh rank {rank} failed:\n{value}")
            got[rank] = value
        for p in procs:
            p.join(60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
        shutil.rmtree(rendezvous, ignore_errors=True)
    return [got[r] for r in range(world)]


def run_meshed(fn: Callable, config: MeshConfig, device: DeviceLike = None, args: Sequence = ()):
    """Run ``fn(*args)`` on every rank of a ``config`` mesh (any axis sizes,
    fsdp included) and return rank 0's result: this process's rank under
    ``torchrun``, else one spawned rank per card (per CPU process with
    ``device="cpu"``).  Raises
    ``ValueError`` when the mesh wants more cards than the host has, or
    when ``torchrun``'s world is not the mesh's size."""
    from i2v_adapter_tpu_torch.parallel.mesh import init_distributed

    n = config.data * config.fsdp * config.tensor * config.seq
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        _, world = init_distributed(device=device)
        if world != n:
            raise ValueError(f"the mesh {config} has {n} ranks, torchrun started {world}")
        return fn(*args)
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > cards:
            raise ValueError(f"the mesh {config} needs {n} cards, {cards} visible")
    return run_ranks(fn, n, args, device)[0]
