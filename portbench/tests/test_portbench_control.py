"""The control (the reference one precision step below the configuration,
in the program's place) has to fail the cell's check: at the tiny sizes on
the CPU here, and at the cell's own size on the card (``gpu``)."""

import argparse

import pytest

from portbench import control
from portbench import run as bench
from portbench.tests.common import CELLS


def env_of(cell, rehearse):
    return bench.environment(argparse.Namespace(workload=cell, seed=0, seconds=0, trace=0, rehearse=rehearse))


def fails(env, seed) -> bool:
    readings = control.readings(env, seed)
    return any(value > env.limits[name] for name, value in readings.items())


@pytest.mark.parametrize("cell", ["serve256_clip", "train256_b8"])
def test_control_fails_at_tiny_size(cell):
    env = env_of(cell, rehearse=True)
    assert fails(env, 3_000_000_031)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's own size")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_cell_size(cell, card):
    from portbench.reference.serve import exact_fp32

    exact_fp32()
    assert fails(env_of(cell, rehearse=False), 3_000_000_041)
