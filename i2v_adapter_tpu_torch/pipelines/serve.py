"""Directory-queue serving daemon: a resident process around the warm
pipeline (the PyTorch port of the JAX package's ``pipelines/serve.py``).

The daemon watches a directory:

  requests/<id>.json   -> {"prompt": ..., "image": <path>, ...overrides}
  output/<id>.gif      +  output/<id>.result.json

Request files are claimed by atomic rename (``<id>.json.working``), so
several daemons can share one queue directory; finished requests are
renamed ``.done`` / ``.failed``.  A request that fails (an unreadable image,
an option the port refuses, a CUDA out-of-memory error, non-finite output)
writes its error to the result JSON and the daemon serves the next one: a
poison request never takes the worker down.  A request that outlives
``request_timeout`` fails and the worker returns, for a supervisor to
restart it on a fresh device context.

Request JSON fields (all but ``prompt`` + ``image`` optional):
  prompt, image (path), negative_prompt, num_frames, height, width,
  num_inference_steps, guidance_scale, frame_similarity_sample_ratio,
  seed, fps, format ('gif' | 'mp4' | 'npy'), dispatch ('auto',
  'scan' or 'stepwise'), encoder_cache (1 or 2) and cfg_cutoff (in
  [0, 1]).  A request over the card's memory envelope fails with the
  pipeline's ``ValueError`` before anything runs.

Run: ``python -m i2v_adapter_tpu_torch.pipelines.serve
--pretrained_model_path ... --requests_dir requests/ --output_dir output/``
(on the GPU; ``--device cpu`` runs on the CPU).

``--mesh data,tensor,seq`` serves each clip over data x tensor x seq cards
(``I2VAdapterPipeline.enable_mesh``), one process per card: run alone, the
daemon spawns them (``--device cpu``: gloo ranks on the CPU); under
``torchrun --nproc_per_node N`` each process is one.  Rank 0 claims each
request and broadcasts it, every rank runs it, rank 0 exports the result
and writes its JSON.  A request that fails on any rank fails on all (the
ranks exchange their outcome after each request; ``failed_ranks`` in the
result JSON), and every rank drops its step graphs and cached blocks
before the next.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import threading
import time

import numpy as np
import torch

from i2v_adapter_tpu_torch.utils import tracing

logger = logging.getLogger(__name__)


class RequestTimeout(Exception):
    """A request exceeded the per-request wall-clock bound."""


def _run_with_timeout(fn, timeout: float | None):
    """Run ``fn()`` bounded by ``timeout`` seconds of wall clock.

    A call blocked inside the CUDA runtime cannot be interrupted by a signal, so
    the request runs in a daemon thread and the caller waits with a
    timeout.  On timeout the thread cannot be killed (it may hold a wedged
    device context), so the caller fails the request and recycles the
    worker process; the daemon flag lets process exit reap the thread."""
    if timeout is None:
        return fn()
    box: dict = {}

    def target():
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 -- re-raised in the caller
            box["error"] = e

    th = threading.Thread(target=target, daemon=True)
    th.start()
    th.join(timeout)
    if th.is_alive():
        raise RequestTimeout(
            f"request exceeded the {timeout:.1f}s wall-clock bound; the request "
            "thread may be wedged on the device -- recycling the worker"
        )
    if "error" in box:
        raise box["error"]
    return box["value"]


_REQUEST_KEYS = (
    "negative_prompt", "num_frames", "height", "width",
    "num_inference_steps", "guidance_scale",
    "frame_similarity_sample_ratio", "dispatch", "encoder_cache",
    "cfg_cutoff",
)


def _claim(path: str) -> str | None:
    """Atomically claim a request file; None if another worker got it."""
    working = path + ".working"
    try:
        os.rename(path, working)
        return working
    except OSError:
        return None


def process_request(pipe, req: dict, out_prefix: str, export: bool = True) -> dict:
    """Run one request through the pipeline; returns the result record.
    The request is a ``job`` span (``utils.tracing``) around ``load`` (the
    image read), the pipeline's ``request`` and ``export``; the record
    carries its id (``span_root``) and the ms of its spans summed by name
    (``spans_ms``).  ``export=False`` (a mesh's other ranks) writes
    nothing."""
    from i2v_adapter_tpu_torch.utils import image as image_utils

    t0 = time.time()
    with tracing.span("job") as job:
        with tracing.span("load"):
            image = image_utils.load_image(req["image"])
        kwargs = {k: req[k] for k in _REQUEST_KEYS if k in req}
        video = pipe(req["prompt"], condition_image=image, seed=int(req.get("seed", 0)), **kwargs)
        fmt = req.get("format", "gif")
        fps = int(req.get("fps", 8))
        if fmt not in ("gif", "mp4", "npy"):
            raise ValueError(f"unknown format {fmt!r} (gif/mp4/npy)")
        with tracing.span("export"):
            if not export:
                outputs = []
            elif fmt == "gif":
                outputs = pipe.export_gifs(video, out_prefix, fps=fps)
            elif fmt == "mp4":
                outputs = [image_utils.export_to_mp4(video[i], f"{out_prefix}_{i}.mp4", fps=fps)
                           for i in range(video.shape[0])]
            else:
                outputs = [out_prefix + ".npy"]
                np.save(outputs[0], video)
    spans_ms: dict = {}
    for s in job.unit + [job]:
        spans_ms[s.name] = spans_ms.get(s.name, 0.0) + s.ms
    return {
        "ok": True,
        "outputs": outputs,
        "shape": list(video.shape),
        "latency_s": round(time.time() - t0, 3),
        "span_root": job.id,
        "spans_ms": {name: round(ms, 3) for name, ms in spans_ms.items()},
    }


def _next_request(requests_dir: str, poll_interval: float, drain: bool):
    """Claim the oldest request of the queue: ``(id, working path, request,
    error)`` with the JSON's read error as ``"Type: message"``; None when
    draining and the queue is empty (else wait for one)."""
    while True:
        pending = sorted(
            (f for f in os.listdir(requests_dir) if f.endswith(".json")),
            key=lambda f: os.path.getmtime(os.path.join(requests_dir, f)),
        )
        for name in pending:
            working = _claim(os.path.join(requests_dir, name))
            if working is None:
                continue  # another worker took it
            try:
                with open(working) as f:
                    return name[: -len(".json")], working, json.load(f), None
            except Exception as e:  # noqa: BLE001 -- malformed JSON fails this request only
                return name[: -len(".json")], working, None, f"{type(e).__name__}: {e}"
        if drain:
            return None
        time.sleep(poll_interval)


def _share(obj, mesh):
    """Rank 0's ``obj`` on every rank of the mesh (over its gloo control
    group); ``obj`` itself without one."""
    if mesh is None or mesh.control is None:
        return obj
    import torch.distributed as dist

    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.control)
    return box[0]


def _agree(result: dict, mesh) -> dict:
    """Every rank's outcome of one request, made one: the first failing
    rank's result with ``failed_ranks``, else rank 0's."""
    if mesh is None or mesh.control is None:
        return result
    import torch.distributed as dist

    results = [None] * dist.get_world_size(mesh.control)
    dist.all_gather_object(results, result, group=mesh.control)
    failed = [r for r, res in enumerate(results) if not res["ok"]]
    if not failed:
        return results[0]
    return dict(results[failed[0]], failed_ranks=failed,
                timed_out=any(res.get("timed_out", False) for res in results))


def serve(
    pipe,
    requests_dir: str,
    output_dir: str,
    poll_interval: float = 0.5,
    max_requests: int | None = None,
    request_timeout: float | None = None,
    mesh=None,
) -> int:
    """Serve until interrupted (or until ``max_requests`` are processed, or
    the queue is empty when ``max_requests`` is set).  Returns the number of
    requests processed.

    ``request_timeout`` bounds each request's wall clock: a request that
    hangs the device fails with ``RequestTimeout`` and the loop returns, so
    that a supervisor restarts the worker (the stuck thread cannot be
    killed; process exit reaps it).  Size it for the slowest legitimate
    request, kernel builds of a first request included.

    With ``mesh`` (the pipeline's, after ``enable_mesh``) every rank of the
    group calls this: rank 0 claims and writes, all ranks run each request
    (see the module docstring)."""
    leader = mesh is None or mesh.rank == 0
    if leader:
        os.makedirs(requests_dir, exist_ok=True)
        os.makedirs(output_dir, exist_ok=True)
        logger.info("serving %s -> %s", requests_dir, output_dir)
    done = 0
    while max_requests is None or done < max_requests:
        item = _next_request(requests_dir, poll_interval, max_requests is not None) if leader else None
        item = _share(item, mesh)
        if item is None:
            break  # drain mode: queue empty, stop
        rid, working, req, error = item
        out_prefix = os.path.join(output_dir, rid)
        t0 = time.time()
        try:
            if error is not None:
                result = {"ok": False, "error": error}
            else:
                kw = {} if leader else {"export": False}
                result = _run_with_timeout(lambda: process_request(pipe, req, out_prefix, **kw), request_timeout)
        except KeyboardInterrupt:
            if leader:
                os.rename(working, working[: -len(".working")])  # un-claim
            raise
        except RequestTimeout as e:
            result = {"ok": False, "error": f"{type(e).__name__}: {e}", "timed_out": True}
            logger.error("request %s timed out: %s", rid, result["error"])
        except Exception as e:  # noqa: BLE001 -- a poison request (bad image,
            # refused option, CUDA out of memory, NaN guard) must never take
            # the serving worker down
            result = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            logger.warning("request %s failed: %s", rid, result["error"], exc_info=True)
        result.setdefault("latency_s", round(time.time() - t0, 3))
        result = _agree(result, mesh)
        timed_out = result.pop("timed_out", False)
        if not result["ok"]:
            # the failed request's tensors are freed with its traceback;
            # drop the kept step graphs and return the cached blocks, so
            # the next request has the whole card
            pipe.release_graphs()
            if torch.cuda.is_initialized():
                torch.cuda.empty_cache()
        if leader:
            with open(out_prefix + ".result.json", "w") as f:
                json.dump(result, f, indent=1)
            os.rename(working, working[: -len(".working")] + (".done" if result["ok"] else ".failed"))
        done += 1
        logger.info("[%d] %s %s (%.2fs)", done, rid, "ok" if result["ok"] else "FAILED", result["latency_s"])
        if timed_out:
            # the stuck request thread may hold a wedged device context:
            # stop claiming work and let the supervisor restart the worker
            logger.error("recycling worker after request timeout")
            return done
    return done


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="I2V-Adapter serving daemon (PyTorch port)")
    p.add_argument("--pretrained_model_path", type=str, required=True)
    p.add_argument("--task_name", type=str, default=None,
                   help="optional adapter checkpoint task (as in the CLI)")
    p.add_argument("--checkpoint_epoch", type=int, default=None)
    p.add_argument("--checkpoint_dir", type=str, default="checkpoint")
    p.add_argument("--requests_dir", type=str, default="requests")
    p.add_argument("--output_dir", type=str, default="output")
    p.add_argument("--poll_interval", type=float, default=0.5)
    p.add_argument("--max_requests", type=int, default=None,
                   help="exit after N requests, or when the queue is empty (smoke runs); "
                        "default: forever")
    p.add_argument("--request_timeout", type=float, default=None,
                   help="per-request wall-clock bound in seconds; on timeout the request "
                        "fails and the worker exits for a supervisor restart (see serve())")
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--num_inference_steps", type=int, default=25)
    p.add_argument("--dtype", type=str, default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--int8_conv", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--mesh", type=str, default=None,
                   help="multi-card serving mesh 'data,tensor,seq': one process per card, spawned "
                        "here or started by torchrun")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the current CUDA device; 'cpu' runs on the CPU)")
    return p.parse_args(argv)


def adapter_checkpoint(checkpoint_dir: str, task_name: str | None, epoch: int | None) -> str | None:
    """``<checkpoint_dir>/<task>/epoch_<N>/i2v_adapter/diffusion_pytorch_model.
    safetensors`` for ``epoch`` (default: the task's latest), or None
    without a task or an epoch directory."""
    from i2v_adapter_tpu_torch.training.checkpoint import find_latest_epoch

    if not task_name:
        return None
    task_dir = os.path.join(checkpoint_dir, task_name)
    epoch = epoch or find_latest_epoch(task_dir)
    if epoch is None:
        return None
    return os.path.join(task_dir, f"epoch_{epoch}", "i2v_adapter", "diffusion_pytorch_model.safetensors")


def build_pipeline(args, model_config, mesh_config):
    """The pipeline ``args`` ask for, on this rank's card with the mesh
    enabled when ``mesh_config`` is given; returns ``(pipe, mesh)``."""
    from i2v_adapter_tpu_torch.config import PipelineConfig
    from i2v_adapter_tpu_torch.parallel.mesh import create_mesh
    from i2v_adapter_tpu_torch.pipelines.i2v_pipeline import I2VAdapterPipeline

    mesh = None if mesh_config is None else create_mesh(mesh_config, device=args.device)
    adapter_path = adapter_checkpoint(args.checkpoint_dir, args.task_name, args.checkpoint_epoch)
    if adapter_path:
        logger.info("using adapter checkpoint %s", adapter_path)
    else:
        logger.warning("no adapter checkpoint found; zero-init adapter")
    keys = ("num_frames", "height", "width", "num_inference_steps", "dtype", "int8_conv",
            "guidance_scale", "frame_similarity_sample_ratio")
    pc = PipelineConfig(**{k: getattr(args, k) for k in keys if hasattr(args, k)})
    pipe = I2VAdapterPipeline.from_pretrained(
        args.pretrained_model_path, model_config=model_config, pipeline_config=pc,
        i2v_adapter_path=adapter_path, device=args.device if mesh is None else mesh.device,
    )
    if mesh is not None:
        pipe.enable_mesh(mesh)
        logger.info("serving over mesh %s, rank %d", mesh.shape, mesh.rank)
    return pipe, mesh


def _serve_rank(argv, model_config, mesh_config) -> int:
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    pipe, mesh = build_pipeline(args, model_config, mesh_config)
    return serve(
        pipe, args.requests_dir, args.output_dir,
        poll_interval=args.poll_interval, max_requests=args.max_requests,
        request_timeout=args.request_timeout, mesh=mesh,
    )


def main(argv=None, model_config=None) -> int:
    """Load the pipeline and serve.  ``model_config`` (default: SD1.5,
    ``I2VModelConfig()``) is for callers that load another architecture
    from code; the command line always loads SD1.5.  With ``--mesh`` every
    rank serves and rank 0's count is returned."""
    from i2v_adapter_tpu_torch.parallel.launch import run_meshed
    from i2v_adapter_tpu_torch.parallel.mesh import parse_mesh

    logging.basicConfig(level=logging.INFO)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if args.mesh:
        config = parse_mesh(args.mesh)
        return run_meshed(_serve_rank, config, args.device, (argv, model_config, config))
    return _serve_rank(argv, model_config, None)


if __name__ == "__main__":
    main()
