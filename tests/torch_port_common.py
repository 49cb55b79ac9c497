"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_port_*).

Parameters come from the Flax module's own ``init`` signature (traced with
``jax.eval_shape``, so nothing is compiled) and are filled from a numpy
seed: fan-in-scaled matrices, norm scales near 1, small vectors.  The same
numpy tree feeds the JAX module and, through ``load_flax_params``, the port.

Each port test file imports ``one_torch_thread``, which runs its tests on
one torch intra-op thread.
"""

import jax
import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's CPU tests use tiny shapes, so one thread loses nothing
    alone.  Under several pytest workers on a few cores, torch's default
    pool (one thread per core in every worker) waits in its barriers for
    threads that are descheduled: six workers running the remat test at
    once took 128 s per test at the default count and 2.4 s at one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def maxerr(a, b) -> float:
    """Max-abs error relative to max |b| (floored at 1)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))), 1.0)


def psnr(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    peak = float(np.max(np.abs(b))) or 1.0
    mse = float(np.mean((a - b) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(peak * peak / mse)


def _fill(tree, rng, path=()):
    if isinstance(tree, dict):
        return {k: _fill(v, rng, path + (k,)) for k, v in tree.items()}
    shape, leaf = tree.shape, path[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    if leaf == "scale":
        return 1.0 + 0.1 * x
    if leaf == "kernel":
        return x / np.sqrt(float(np.prod(shape[:-1])))
    if leaf == "bias":
        return 0.1 * x
    return 0.05 * x  # embeddings and raw parameters


def random_params(module, *args, seed: int = 0, method=None, **kwargs):
    """Seeded numpy params ``{"params": ...}`` for ``module.init(*args)``."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, method=method, **kwargs)
    )
    return {"params": _fill(shapes["params"], np.random.default_rng(seed))}
