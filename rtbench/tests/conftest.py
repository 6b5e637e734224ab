"""Shared helpers: one run of a cell on the CPU at a size a test holds
(the kinds' plain path; the card's look skipped), and the card fixture
of the tests marked `cuda`."""
from __future__ import annotations

import argparse
import time

import pytest
import torch

from rtbench import run

# the cells at test size: 32 x 32 frames
SMALL = {"render": dict(width=32, height=32, band_rows=8),
         "train": dict(width=32, height=32)}


@pytest.fixture(autouse=True, scope="session")
def few_threads():
    torch.set_num_threads(2)


def small(cell: str):
    kind = "render" if "render" in cell else "train"
    return SMALL[kind]


def run_small(cell: str, seed: int = 2 ** 31 + 77, seconds: float = 0.5,
              trace: int = 0) -> dict:
    """execute() of the cell on the CPU at test size."""
    args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds,
                              trace=trace)
    return run.execute(args, "cpu", time.perf_counter(), small(cell))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")
