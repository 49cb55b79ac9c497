"""Metrics log, step timer and profiler hooks of the training driver.

The port's copy of the JAX package's ``utils/metrics.py``: JSONL metrics
(always), TensorBoard (through ``torch.utils.tensorboard``) and Weights &
Biases when their packages import; a step timer that synchronises the card
before it reads the clock; a ``torch.profiler`` capture of a range of steps
written as a Chrome trace with the program's spans merged in.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import torch

from i2v_adapter_tpu_torch.utils import tracing


class MetricsLogger:
    """Append-only ``metrics.jsonl`` in ``log_dir`` plus the optional
    trackers; each tracker activates only if its package imports."""

    def __init__(
        self,
        log_dir: str,
        use_tensorboard: bool = True,
        use_wandb: bool = False,
        wandb_project: str = "i2v_adapter_tpu",
        run_config: Optional[dict] = None,
    ):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._tb = None
        self._wandb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except Exception:  # noqa: BLE001 - tensorboard is optional
                self._tb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(project=wandb_project, dir=log_dir, config=run_config,
                                         resume="allow")
            except Exception:  # noqa: BLE001 - wandb is optional
                self._wandb = None

    def log(self, step: int, metrics: dict) -> None:
        record = {"step": step, "time": time.time(), **metrics}
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, v, global_step=step)
            self._tb.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def finish(self) -> None:
        if self._tb is not None:
            self._tb.close()
            self._tb = None
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None

    def read(self) -> list:
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f]


class StepTimer:
    """Context manager timing one step on the host's clock, after
    synchronising ``device`` when it is a CUDA device (so the time covers
    the step's kernels, not just their launches).  The first step is kept
    apart (``compile_time``: first-use costs such as cuDNN plans) and
    excluded from the running mean."""

    def __init__(self, device=None):
        dev = torch.device(device) if device is not None else None
        self._sync = dev is not None and dev.type == "cuda"
        self._device = dev
        self.last: float = 0.0
        self._total = 0.0
        self._count = 0
        self._t0: Optional[float] = None
        self.compile_time: Optional[float] = None

    def _synchronize(self) -> None:
        if self._sync:
            torch.cuda.synchronize(self._device)

    def __enter__(self):
        self._synchronize()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._synchronize()
        self.last = time.perf_counter() - self._t0
        if self.compile_time is None:
            self.compile_time = self.last
        else:
            self._total += self.last
            self._count += 1
        return False

    @property
    def mean(self) -> float:
        return self._total / self._count if self._count else self.last

    @property
    def rate(self) -> float:
        m = self.mean
        return 1.0 / m if m > 0 else 0.0


class Profiler:
    """``torch.profiler`` capture of steps ``[start_step, start_step +
    num_steps)``: call ``step(i)`` before each step; the trace is written to
    ``log_dir/trace.json`` (Chrome trace format) when the range ends, with
    the program's spans (``utils.tracing``) merged on its time axis."""

    def __init__(self, log_dir: str, start_step: int, num_steps: int):
        self.log_dir = log_dir
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self._prof = None
        self.trace_path: Optional[str] = None

    def step(self, step: int) -> None:
        if step == self.start_step and self._prof is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.__enter__()
        elif step >= self.stop_step and self._prof is not None:
            self.stop()

    def stop(self) -> None:
        if self._prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        os.makedirs(self.log_dir, exist_ok=True)
        self.trace_path = os.path.join(self.log_dir, "trace.json")
        self._prof.export_chrome_trace(self.trace_path)
        tracing.export_chrome(self.trace_path, merge=self.trace_path)
        self._prof = None
