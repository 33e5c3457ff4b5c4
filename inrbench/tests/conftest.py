"""Shared helpers of the benchmark's CPU tests: a cell of the real
``BENCHMARK.json`` with its traffic cut to a size the CPU runs in a
moment (widths stay as configured)."""

from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

SMALL = {
    "closed": {"grid": [16, 16], "check_block": 100},
    "fit": {"grid": [12, 12]},
}


def small_cell(name: str):
    from inrbench import harness
    cell = harness.find_cell(ROOT, name)
    cell.traffic.update(SMALL[cell.traffic["loop"]])
    return cell


def run_small(name: str, *, seed: int = 2**31 + 7, seconds: float = 0.3,
              control: bool = False, trace: bool = False, cell=None):
    from inrbench import harness
    cell = cell or small_cell(name)
    return harness.run_cell(ROOT, name, seed, seconds, trace, device="cpu",
                            control=control, t_start=time.perf_counter(),
                            cell=cell, log=lambda m: None)


@pytest.fixture
def cuda_card():
    """Skips a test that needs a CUDA card where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return torch.device("cuda:0")
