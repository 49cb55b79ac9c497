"""Training driver: command line and epoch loop, on one GPU.

The port's counterpart of the JAX package's ``training/driver.py``: build
the WebVid dataset and its loader, load a diffusers-layout checkpoint
directory with ``I2VAdapterPipeline.from_pretrained``, freeze, train with
``make_train_step``, write adapter checkpoints every ``checkpoint_epoch``
epochs (the EMA weights with ``--use_ema``, the live ones under
``non_ema/``), full train states every ``checkpointing_steps`` steps,
sample validation GIFs every ``validation_epoch`` epochs and export the
whole pipeline at the end.

Run: ``python -m i2v_adapter_tpu_torch.training.driver --task_name X
--pretrained_model_path ... --csv_path ... --video_folder ... [--device cpu]``

The flags are the JAX driver's, plus ``--device`` (default: the current
CUDA device).  Multi-device training (``--data_fsdp``, ``--seq_parallel``)
and the scaling bench (``--bench_scaling``) are not ported and raise
``NotImplementedError``.  The train step runs the UNet with exact convs;
the pipeline's int8 serving convs are switched on only around validation
samples, which are made from the trained (EMA) weights.  Each step's
random numbers come from ``make_train_step``'s generator, seeded with
``--seed`` plus the step, so a resumed run draws what an uninterrupted one
would have.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from i2v_adapter_tpu_torch.config import (
    I2VModelConfig,
    MeshConfig,
    OptimizerConfig,
    PipelineConfig,
    TrainConfig,
)
from i2v_adapter_tpu_torch.data.loader import DataLoader
from i2v_adapter_tpu_torch.data.webvid import WebVidDataset
from i2v_adapter_tpu_torch.device import resolve_device
from i2v_adapter_tpu_torch.pipelines.i2v_pipeline import I2VAdapterPipeline
from i2v_adapter_tpu_torch.training import checkpoint as ckpt
from i2v_adapter_tpu_torch.training.state import create_train_state
from i2v_adapter_tpu_torch.training.train_i2v import make_train_step
from i2v_adapter_tpu_torch.utils.metrics import MetricsLogger, Profiler, StepTimer

logger = logging.getLogger(__name__)


def parse_args(argv=None) -> argparse.Namespace:
    """The JAX driver's flags, defaults and required-argument error, plus
    ``--device``."""
    p = argparse.ArgumentParser(description="I2V-Adapter training (GPU)")
    p.add_argument("--train_mode", type=str, default="i2v", choices=["i2v", "t2i"],
                   help="'i2v': adapter/motion finetune on clips; 't2i': "
                        "full-UNet single-frame base finetune")
    p.add_argument("--task_name", type=str, default=None)
    p.add_argument("--pretrained_model_path", type=str, default=None,
                   help="dir with unet/ vae/ text_encoder/ tokenizer/ "
                        "motion_adapter/ image_encoder/ ip_adapter/")
    p.add_argument("--csv_path", type=str, default=None)
    p.add_argument("--video_folder", type=str, default=None)
    p.add_argument("--eval_csv_path", type=str, default=None)
    p.add_argument("--output_dir", type=str, default="checkpoint")
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--n_frames", type=int, default=16)
    p.add_argument("--sample_stride", type=int, default=4)
    p.add_argument("--train_batch_size", type=int, default=8)
    p.add_argument("--gradient_accumulation_steps", type=int, default=4)
    p.add_argument("--num_train_epochs", type=int, default=10)
    p.add_argument("--max_train_steps", type=int, default=None)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--scale_lr", action="store_true")
    p.add_argument("--lr_scheduler", type=str, default="constant")
    p.add_argument("--lr_warmup_steps", type=int, default=500)
    p.add_argument("--optimizer", type=str, default="adamw", choices=["adamw", "adafactor"],
                   help="adafactor = factored second moments; runs classic "
                        "Adafactor, adam_beta*/weight_decay/epsilon are ignored")
    p.add_argument("--adam_beta1", type=float, default=0.9)
    p.add_argument("--adam_beta2", type=float, default=0.999)
    p.add_argument("--adam_weight_decay", type=float, default=1e-2)
    p.add_argument("--adam_epsilon", type=float, default=1e-8)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--snr_gamma", type=float, default=None)
    p.add_argument("--noise_offset", type=float, default=0.0)
    p.add_argument("--input_perturbation", type=float, default=0.0)
    p.add_argument("--prediction_type", type=str, default=None)
    p.add_argument("--text_padding", type=str, default="max_length", choices=["max_length", "longest"],
                   help="prompt tokenization padding: 'max_length' (default) matches the "
                        "conditioning length the pipeline serves with; 'longest' pads each "
                        "batch to its longest prompt, rounded up to a multiple of 8")
    p.add_argument("--mixed_precision", type=str, default="bfloat16", choices=["none", "bfloat16"])
    p.add_argument("--freeze_dtype", type=str, default="float32", choices=["float32", "bfloat16"],
                   help="storage dtype for frozen params (UNet backbone, VAE, CLIP)")
    p.add_argument("--gradient_checkpointing", action="store_true")
    p.add_argument("--vae_encode_slice", type=int, default=0,
                   help="VAE-encode N frames at a time in the train step (0 = full batch)")
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--update_motion_modules", action="store_true")
    p.add_argument("--uncond_prob_t", type=float, default=0.0)
    p.add_argument("--uncond_prob_i", type=float, default=0.0)
    p.add_argument("--uncond_prob_ti", type=float, default=0.0)
    p.add_argument("--first_frame_mode", type=str, default="scaled", choices=["scaled", "exact"])
    p.add_argument("--checkpoint_epoch", type=int, default=2)
    p.add_argument("--checkpointing_steps", type=int, default=0,
                   help="also write full train-state checkpoints (params + optimizer + "
                        "step) every N steps (0 = off)")
    p.add_argument("--checkpoints_total_limit", type=int, default=None)
    p.add_argument("--async_checkpoint", action="store_true",
                   help="write train-state checkpoints on a background thread after "
                        "copying the tensors to host memory")
    p.add_argument("--resume_from_checkpoint", type=str, default=None,
                   help="adapter epoch dir, or 'latest' to restore the newest full "
                        "train-state checkpoint")
    p.add_argument("--start_epoch", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--data_fsdp", type=int, default=1,
                   help="fsdp axis size of the mesh (not ported: > 1 raises)")
    p.add_argument("--seq_parallel", type=int, default=1,
                   help="seq axis size (not ported: > 1 raises)")
    p.add_argument("--fsdp_frozen", type=str, default="shard", choices=["shard", "replicate"],
                   help="placement of the no-gradient state on the fsdp axis "
                        "(no effect on one device)")
    p.add_argument("--validation_epoch", type=int, default=0,
                   help="sample eval GIFs every N epochs (0 = off)")
    p.add_argument("--profile_steps", type=int, default=0,
                   help="capture a torch.profiler trace for N steps")
    p.add_argument("--report_to", type=str, default="tensorboard",
                   choices=["tensorboard", "wandb", "all", "none"],
                   help="metric trackers in addition to the always-on JSONL; each "
                        "activates only if its package imports")
    p.add_argument("--wandb_project", type=str, default="i2v_adapter_tpu")
    p.add_argument("--bench_scaling", action="store_true",
                   help="the JAX package's weak-scaling bench (not ported: raises)")
    p.add_argument("--bench_mesh_shapes", type=str, default="1,1,1;2,1,1;4,1,1;2,2,1;4,2,1;2,2,2")
    p.add_argument("--bench_steps", type=int, default=4)
    p.add_argument("--bench_model", type=str, default="sd15", choices=["sd15", "tiny"])
    p.add_argument("--bench_output", type=str, default="bench_scaling.jsonl")
    p.add_argument("--bench_cpu_sim", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the current CUDA device; 'cpu' runs on the CPU)")
    args = p.parse_args(argv)
    if not args.bench_scaling:
        missing = [n for n in ("task_name", "pretrained_model_path", "csv_path", "video_folder")
                   if getattr(args, n) is None]
        if missing:
            p.error(f"the following arguments are required: {', '.join('--' + m for m in missing)}")
    return args


def refuse_multi_gpu(args) -> None:
    """Raise for the JAX driver's multi-device options."""
    for flag, on in (("--data_fsdp", args.data_fsdp > 1), ("--seq_parallel", args.seq_parallel > 1),
                     ("--bench_scaling", args.bench_scaling)):
        if on:
            raise NotImplementedError(f"{flag}: multi-GPU training is not ported yet (ROADMAP: multi-GPU)")


def args_to_train_config(args) -> TrainConfig:
    return TrainConfig(
        train_mode=args.train_mode,
        resolution=args.resolution,
        num_frames=args.n_frames,
        sample_stride=args.sample_stride,
        train_batch_size=args.train_batch_size,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        num_train_epochs=args.num_train_epochs,
        max_train_steps=args.max_train_steps,
        seed=args.seed,
        update_motion_modules=args.update_motion_modules,
        snr_gamma=args.snr_gamma,
        noise_offset=args.noise_offset,
        input_perturbation=args.input_perturbation,
        prediction_type=args.prediction_type,
        uncond_prob_t=args.uncond_prob_t,
        uncond_prob_i=args.uncond_prob_i,
        uncond_prob_ti=args.uncond_prob_ti,
        first_frame_mode=args.first_frame_mode,
        gradient_checkpointing=args.gradient_checkpointing,
        vae_encode_slice=args.vae_encode_slice,
        mixed_precision=args.mixed_precision,
        freeze_dtype=args.freeze_dtype,
        use_ema=args.use_ema,
        optimizer=OptimizerConfig(
            learning_rate=args.learning_rate,
            lr_scheduler=args.lr_scheduler,
            lr_warmup_steps=args.lr_warmup_steps,
            optimizer=args.optimizer,
            adam_beta1=args.adam_beta1,
            adam_beta2=args.adam_beta2,
            adam_weight_decay=args.adam_weight_decay,
            adam_epsilon=args.adam_epsilon,
            max_grad_norm=args.max_grad_norm,
            scale_lr=args.scale_lr,
        ),
        mesh=MeshConfig(data=-1, fsdp=args.data_fsdp, seq=args.seq_parallel),
        fsdp_frozen=getattr(args, "fsdp_frozen", "shard"),
        checkpoint_epoch=args.checkpoint_epoch,
        checkpoints_total_limit=args.checkpoints_total_limit,
    )


def setup(args, model_config: Optional[I2VModelConfig] = None) -> dict:
    """Everything ``train`` builds before its first step: ``train_config``,
    ``model_config`` (after the t2i surgery, with exact convs), ``device``,
    ``dataset``, ``loader``, ``steps_per_epoch``, ``total_steps``, ``pipe``
    (the pipeline, its modules shared with the state), ``state`` (adapters
    resumed from the newest epoch checkpoint when there is one),
    ``first_epoch`` and ``task_dir``."""
    refuse_multi_gpu(args)
    dev = resolve_device(getattr(args, "device", None))
    tc = args_to_train_config(args)
    model_config = model_config or I2VModelConfig()
    if tc.train_mode == "t2i":
        # base finetune: the plain per-frame SD UNet, no adapter / motion / IP
        model_config = model_config.replace(unet=model_config.unet.replace(
            use_motion_modules=False, use_i2v_adapter=False, use_ip_adapter=False))

    dataset = WebVidDataset(
        args.csv_path, args.video_folder, sample_size=tc.resolution, sample_stride=tc.sample_stride,
        sample_n_frames=tc.num_frames, is_image=tc.train_mode == "t2i",
        clip_image_size=model_config.image_encoder.image_size, seed=tc.seed)
    loader = DataLoader(dataset, tc.train_batch_size, shuffle=True, num_workers=args.num_workers,
                        seed=tc.seed)
    steps_per_epoch = max(len(loader), 1)
    total_steps = tc.max_train_steps or steps_per_epoch * tc.num_train_epochs
    if tc.optimizer.scale_lr:
        scaled = tc.optimizer.learning_rate * tc.gradient_accumulation_steps * tc.train_batch_size
        tc = tc.replace(optimizer=tc.optimizer.replace(learning_rate=scaled))

    # the train step runs exact convs, as the JAX step's own UNet does;
    # validation switches the serving default's int8 convs on around itself
    pipe = I2VAdapterPipeline.from_pretrained(
        args.pretrained_model_path, model_config,
        PipelineConfig(dtype="bfloat16" if tc.mixed_precision == "bfloat16" else "float32", int8_conv=False),
        device=dev)
    model_config = pipe.config

    task_dir = os.path.join(args.output_dir, args.task_name)
    first_epoch = args.start_epoch
    resume_dir = args.resume_from_checkpoint
    resume_full = resume_dir == "latest"
    if resume_dir is None and tc.train_mode == "i2v":
        latest = ckpt.find_latest_epoch(task_dir)
        if latest is not None:
            resume_dir = os.path.join(task_dir, f"epoch_{latest}")
            first_epoch = latest
    if tc.train_mode == "i2v" and not resume_full and resume_dir is not None and os.path.isdir(resume_dir):
        logger.info("resuming adapters from %s", resume_dir)
        ckpt.load_adapter_checkpoint(pipe.unet, model_config.unet, resume_dir)

    state = create_train_state(pipe.unet, tc, total_steps, vae=pipe.vae, text_encoder=pipe.text_encoder,
                               image_encoder=pipe.image_encoder)
    return {"train_config": tc, "model_config": model_config, "device": dev, "dataset": dataset,
            "loader": loader, "steps_per_epoch": steps_per_epoch, "total_steps": total_steps,
            "pipe": pipe, "state": state, "first_epoch": first_epoch, "task_dir": task_dir,
            "resume_full": resume_full}


def _to_device(batch: dict, dev: torch.device) -> dict:
    """numpy batch -> tensors on ``dev`` (through pinned memory to a card)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        out[k] = t
    return out


def train(args, model_config: Optional[I2VModelConfig] = None) -> dict:
    """Run the training loop; returns ``global_step``, ``last_loss`` (the
    last epoch's mean) and the per-step ``losses``, ``grad_norms``,
    ``skipped_nonfinite``, ``step_s`` (synchronised), ``data_wait_s`` (the
    host's wait for the loader) and ``state_saves`` (the full-state saves'
    step, bytes and seconds)."""
    logging.basicConfig(level=logging.INFO)
    s = setup(args, model_config)
    tc, model_config, dev = s["train_config"], s["model_config"], s["device"]
    pipe, state, loader, task_dir = s["pipe"], s["state"], s["loader"], s["task_dir"]
    steps_per_epoch, first_epoch = s["steps_per_epoch"], s["first_epoch"]

    step_ckpt = None
    if args.checkpointing_steps or s["resume_full"]:
        step_ckpt = ckpt.TrainCheckpointer(os.path.join(task_dir, "state"),
                                           max_to_keep=tc.checkpoints_total_limit,
                                           async_save=bool(getattr(args, "async_checkpoint", False)))
    if s["resume_full"] and step_ckpt is not None:
        restored, at_step = step_ckpt.restore(state)
        if restored is not None:
            first_epoch = int(at_step) // max(steps_per_epoch, 1)
            logger.info("restored full train state at step %s", at_step)
    step_fn = make_train_step(model_config, tc, device=dev)

    n_train = sum(p.numel() for p in state.trainable_params().values())
    n_total = sum(p.numel() for p in state.unet.parameters())
    logger.info("trainable params: %.2fM / %.2fM", n_train / 1e6, n_total / 1e6)

    uncond_ids = pipe.tokenizer([""] * tc.train_batch_size, padding="max_length")
    report_to = getattr(args, "report_to", "tensorboard")
    metrics_log = MetricsLogger(
        os.path.join(task_dir, "logs"),
        use_tensorboard=report_to in ("tensorboard", "all"),
        use_wandb=report_to in ("wandb", "all"),
        wandb_project=getattr(args, "wandb_project", "i2v_adapter_tpu"),
        run_config=tc.to_dict(),
    )
    timer = StepTimer(dev)
    profiler = Profiler(os.path.join(task_dir, "profile"), 2, args.profile_steps) if args.profile_steps else None
    global_step = int(first_epoch * steps_per_epoch)
    record = {k: [] for k in ("losses", "grad_norms", "skipped_nonfinite", "step_s", "data_wait_s")}
    epoch_loss, n_steps = 0.0, 0

    # the loop, validation and export run under a finally that commits any
    # in-flight async save, so an error there cannot lose the write
    body_error = None
    try:
        for epoch in range(first_epoch, tc.num_train_epochs):
            epoch_loss, n_steps = 0.0, 0
            batches = iter(loader)
            while True:
                t0 = time.perf_counter()
                batch = next(batches, None)
                wait = time.perf_counter() - t0
                if batch is None:
                    break
                if profiler is not None:
                    profiler.step(global_step)
                if args.text_padding == "longest":
                    # the reference's recipe, lengths bucketed to multiples of 8
                    text_ids = pipe.tokenizer(batch.pop("text"), padding="longest")
                    ctx = uncond_ids.shape[1]
                    bucket = min(ctx, max(8, -(-text_ids.shape[1] // 8) * 8))
                    if text_ids.shape[1] < bucket:
                        text_ids = np.pad(text_ids, ((0, 0), (0, bucket - text_ids.shape[1])),
                                          constant_values=pipe.tokenizer.eos)
                    u_ids = uncond_ids[: text_ids.shape[0], :bucket]
                else:
                    text_ids = pipe.tokenizer(batch.pop("text"), padding="max_length")
                    u_ids = uncond_ids[: text_ids.shape[0]]
                device_batch = _to_device({"pixel_values": batch["pixel_values"], "clip_image": batch["clip_image"],
                                           "text_ids": text_ids, "uncond_ids": u_ids}, dev)
                with timer:
                    state, metrics = step_fn(state, device_batch)
                loss = float(metrics["loss"])
                epoch_loss += loss
                n_steps += 1
                global_step += 1
                record["losses"].append(loss)
                record["grad_norms"].append(float(metrics["grad_norm"]))
                record["skipped_nonfinite"].append(float(metrics["skipped_nonfinite"]))
                record["step_s"].append(timer.last)
                record["data_wait_s"].append(wait)
                if global_step % 10 == 0:
                    metrics_log.log(global_step, {
                        "train_loss": loss,
                        "grad_norm": float(metrics["grad_norm"]),
                        "step_time_s": timer.last,
                        "steps_per_sec": timer.rate,
                    })
                if step_ckpt is not None and args.checkpointing_steps and global_step % args.checkpointing_steps == 0:
                    step_ckpt.save(global_step, state)
                if tc.max_train_steps and global_step >= tc.max_train_steps:
                    break
            logger.info("epoch %d: mean loss %.4f (%d steps, %.2f s/step)",
                        epoch + 1, epoch_loss / max(n_steps, 1), n_steps, timer.mean)

            if (epoch + 1) % tc.checkpoint_epoch == 0:
                out = os.path.join(task_dir, f"epoch_{epoch + 1}")
                # with --use_ema the checkpoint downstream consumers load is the
                # EMA average; the live weights go to non_ema/
                export = state.ema if tc.use_ema else None
                if tc.train_mode == "t2i":
                    ckpt.export_pipeline({"unet": ckpt.flax_tensors(state.unet, export, "params")},
                                         model_config, out, tc)
                else:
                    ckpt.save_adapter_checkpoint(state.unet, model_config.unet, out,
                                                 save_motion=tc.update_motion_modules, params=export)
                    if tc.use_ema:
                        ckpt.save_adapter_checkpoint(state.unet, model_config.unet, os.path.join(out, "non_ema"),
                                                     save_motion=tc.update_motion_modules)
                logger.info("saved checkpoint: %s", out)

            if args.validation_epoch and (epoch + 1) % args.validation_epoch == 0 and args.eval_csv_path:
                _run_validation(args, pipe, state, model_config, task_dir, epoch)

            if tc.max_train_steps and global_step >= tc.max_train_steps:
                break

        if profiler is not None:
            profiler.stop()
        # the final whole-pipeline export, with the EMA weights under --use_ema
        final = {"unet": ckpt.flax_tensors(state.unet, state.ema, "params"), "vae": pipe.vae,
                 "text_encoder": pipe.text_encoder}
        if pipe.image_encoder is not None:
            final["image_encoder"] = pipe.image_encoder
        ckpt.export_pipeline(final, model_config, os.path.join(task_dir, "pipeline"), tc)
    except BaseException as e:
        body_error = e
        raise
    finally:
        if step_ckpt is not None:
            _commit_saves(step_ckpt, body_error)
    metrics_log.finish()
    return {"global_step": global_step, "last_loss": epoch_loss / max(n_steps, 1), **record,
            "state_saves": step_ckpt.saves if step_ckpt is not None else []}


def _commit_saves(step_ckpt, body_error: Optional[BaseException]) -> None:
    """Wait until any in-flight async save is on disk.  A write error is
    raised when the run itself succeeded; when the run raised
    (``body_error``), the write error is logged beside it and the run's
    error is the one that propagates."""
    try:
        step_ckpt.wait()
    except Exception as write_error:  # noqa: BLE001 - reraised, or logged beside the run's error
        if body_error is None:
            raise
        logger.error("the in-flight full-state save failed too: %r", write_error)


def _run_validation(args, pipe, state, model_config, task_dir, epoch) -> list:
    """Sample the first 4 rows of ``--eval_csv_path`` (``prompt``,
    ``image_path``) at 25 steps with the EMA weights (the live ones without
    EMA) at the serving default (int8 convs), writing GIFs under
    ``samples_epoch_<n>/``; returns the uint8 clips.  The trainables are
    swapped in at the pipeline's dtype, as a pipeline built from the
    exported weights holds them, so the int8 sites quantise the trained
    weights, and swapped back after.  The pipeline's kept step graphs read
    the weights by address, so they are dropped at both swaps."""
    import csv as csv_mod

    from PIL import Image

    with open(args.eval_csv_path, newline="") as f:
        rows = list(csv_mod.DictReader(f))[:4]
    src = state.ema if state.ema is not None else state.trainable_params()
    named = dict(state.unet.named_parameters())
    masters = {n: named[n].data for n in state.trainable}
    out_dir = os.path.join(task_dir, f"samples_epoch_{epoch + 1}")
    os.makedirs(out_dir, exist_ok=True)
    videos = []
    try:
        for n in state.trainable:
            named[n].data = src[n].detach().to(pipe.dtype, copy=True)
        pipe.release_graphs()
        pipe.enable_int8_conv(True)
        for i, row in enumerate(rows):
            video = pipe(row["prompt"], condition_image=Image.open(row["image_path"]),
                         num_frames=args.n_frames, height=args.resolution, width=args.resolution,
                         num_inference_steps=25, seed=i)
            pipe.export_gifs(video, os.path.join(out_dir, f"sample_{i}"))
            videos.append(video)
    finally:
        pipe.enable_int8_conv(False)
        for n in state.trainable:
            named[n].data = masters[n]
        pipe.release_graphs()
    logger.info("validation GIFs -> %s", out_dir)
    return videos


def main(argv=None, model_config: Optional[I2VModelConfig] = None) -> dict:
    """The command line: train and print the result's summary as JSON.
    ``model_config`` (default: SD1.5) is for callers that train another
    architecture from code."""
    result = train(parse_args(argv), model_config)
    summary = {"global_step": result["global_step"], "last_loss": result["last_loss"]}
    if result["step_s"]:
        summary["mean_step_s"] = float(np.mean(result["step_s"]))
        summary["mean_data_wait_s"] = float(np.mean(result["data_wait_s"]))
    print(json.dumps(summary))
    return result


if __name__ == "__main__":
    main()
