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
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import threading
import time

import numpy as np
import torch

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


def process_request(pipe, req: dict, out_prefix: str) -> dict:
    """Run one request through the pipeline; returns the result record."""
    from i2v_adapter_tpu_torch.utils import image as image_utils

    t0 = time.time()
    image = image_utils.load_image(req["image"])
    kwargs = {k: req[k] for k in _REQUEST_KEYS if k in req}
    video = pipe(req["prompt"], condition_image=image, seed=int(req.get("seed", 0)), **kwargs)
    fmt = req.get("format", "gif")
    fps = int(req.get("fps", 8))
    if fmt == "gif":
        outputs = pipe.export_gifs(video, out_prefix, fps=fps)
    elif fmt == "mp4":
        outputs = [image_utils.export_to_mp4(video[i], f"{out_prefix}_{i}.mp4", fps=fps)
                   for i in range(video.shape[0])]
    elif fmt == "npy":
        outputs = [out_prefix + ".npy"]
        np.save(outputs[0], video)
    else:
        raise ValueError(f"unknown format {fmt!r} (gif/mp4/npy)")
    return {
        "ok": True,
        "outputs": outputs,
        "shape": list(video.shape),
        "latency_s": round(time.time() - t0, 3),
    }


def serve(
    pipe,
    requests_dir: str,
    output_dir: str,
    poll_interval: float = 0.5,
    max_requests: int | None = None,
    request_timeout: float | None = None,
) -> int:
    """Serve until interrupted (or until ``max_requests`` are processed, or
    the queue is empty when ``max_requests`` is set).  Returns the number of
    requests processed.

    ``request_timeout`` bounds each request's wall clock: a request that
    hangs the device fails with ``RequestTimeout`` and the loop returns, so
    that a supervisor restarts the worker (the stuck thread cannot be
    killed; process exit reaps it).  Size it for the slowest legitimate
    request, kernel builds of a first request included."""
    os.makedirs(requests_dir, exist_ok=True)
    os.makedirs(output_dir, exist_ok=True)
    done = 0
    logger.info("serving %s -> %s", requests_dir, output_dir)
    while max_requests is None or done < max_requests:
        pending = sorted(
            (f for f in os.listdir(requests_dir) if f.endswith(".json")),
            key=lambda f: os.path.getmtime(os.path.join(requests_dir, f)),
        )
        if not pending:
            if max_requests is not None:
                break  # drain mode: queue empty, stop
            time.sleep(poll_interval)
            continue
        for name in pending:
            if max_requests is not None and done >= max_requests:
                break
            working = _claim(os.path.join(requests_dir, name))
            if working is None:
                continue  # another worker took it
            rid = name[: -len(".json")]
            out_prefix = os.path.join(output_dir, rid)
            t0 = time.time()
            timed_out = False
            try:
                with open(working) as f:
                    req = json.load(f)
                result = _run_with_timeout(lambda: process_request(pipe, req, out_prefix), request_timeout)
            except KeyboardInterrupt:
                os.rename(working, working[: -len(".working")])  # un-claim
                raise
            except RequestTimeout as e:
                timed_out = True
                result = {"ok": False, "error": f"{type(e).__name__}: {e}",
                          "latency_s": round(time.time() - t0, 3)}
                logger.error("request %s timed out: %s", rid, result["error"])
            except Exception as e:  # noqa: BLE001 -- a poison request (bad image,
                # refused option, CUDA out of memory, NaN guard, malformed JSON)
                # must never take the serving worker down
                result = {"ok": False, "error": f"{type(e).__name__}: {e}",
                          "latency_s": round(time.time() - t0, 3)}
                logger.warning("request %s failed: %s", rid, result["error"], exc_info=True)
            if not result["ok"]:
                # the failed request's tensors are freed with its traceback;
                # drop the kept step graphs and return the cached blocks, so
                # the next request has the whole card
                pipe.release_graphs()
                if torch.cuda.is_initialized():
                    torch.cuda.empty_cache()
            with open(out_prefix + ".result.json", "w") as f:
                json.dump(result, f, indent=1)
            os.rename(working, working[: -len(".working")] + (".done" if result["ok"] else ".failed"))
            done += 1
            logger.info("[%d] %s %s (%.2fs)", done, rid, "ok" if result["ok"] else "FAILED",
                        result["latency_s"])
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
                   help="multi-device serving mesh 'data,tensor,seq': not ported yet, refused")
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


def refuse_mesh(mesh: str | None) -> None:
    if mesh:
        raise NotImplementedError(
            f"--mesh {mesh}: multi-device serving is not ported yet (ROADMAP: multi-GPU)")


def main(argv=None, model_config=None) -> int:
    """Load the pipeline and serve.  ``model_config`` (default: SD1.5,
    ``I2VModelConfig()``) is for callers that load another architecture
    from code; the command line always loads SD1.5."""
    from i2v_adapter_tpu_torch.config import PipelineConfig
    from i2v_adapter_tpu_torch.pipelines.i2v_pipeline import I2VAdapterPipeline

    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    refuse_mesh(args.mesh)
    adapter_path = adapter_checkpoint(args.checkpoint_dir, args.task_name, args.checkpoint_epoch)
    pc = PipelineConfig(
        num_frames=args.num_frames, height=args.height, width=args.width,
        num_inference_steps=args.num_inference_steps, dtype=args.dtype,
        int8_conv=args.int8_conv,
    )
    pipe = I2VAdapterPipeline.from_pretrained(
        args.pretrained_model_path, model_config=model_config, pipeline_config=pc,
        i2v_adapter_path=adapter_path, device=args.device,
    )
    return serve(
        pipe, args.requests_dir, args.output_dir,
        poll_interval=args.poll_interval, max_requests=args.max_requests,
        request_timeout=args.request_timeout,
    )


if __name__ == "__main__":
    main()
