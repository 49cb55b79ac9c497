"""Training checkpoints: discovery of a task's epoch directories.

The port's copy of ``find_latest_epoch`` (the JAX package's module imports
JAX, so the port cannot reach it).  The rest of that module (Orbax train
states, adapter save and load) is not ported yet.
"""

from __future__ import annotations

import os
import re
from typing import Optional


def find_latest_epoch(task_dir: str) -> Optional[int]:
    """The highest N of the ``epoch_N`` subdirectories of ``task_dir``, or
    None when there is none (or no ``task_dir``)."""
    if not os.path.isdir(task_dir):
        return None
    best = None
    for name in os.listdir(task_dir):
        m = re.fullmatch(r"epoch_(\d+)", name)
        if m:
            n = int(m.group(1))
            best = n if best is None or n > best else best
    return best
