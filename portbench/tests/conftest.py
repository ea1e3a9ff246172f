"""Cells cut to a size the CPU runs in seconds, for the harness's tests.

The widths and depths here are a test's, not a configuration's: the
benchmark's cells run at the published sizes on the card.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import pytest
import torch

from portbench import spec

ROOT = Path(__file__).resolve().parents[2]

SMALL = dict(ae_width=32, ae_bottleneck_width=4, num_layers=2, width=16, skip_width=8,
             quant_channels=256)


def small(cell: spec.Cell, dtype: str = "float32") -> spec.Cell:
    """``cell`` at the test widths, cut further by its kind's ``small``."""
    cfg, traffic = cell.kind.small(dict(cell.config, **SMALL, compute_dtype=dtype),
                                   cell.traffic)
    return dataclasses.replace(cell, config=cfg, traffic=traffic)


def small_cell(workload: str, dtype: str = "float32") -> spec.Cell:
    return small(spec.resolve(spec.load_benchmark(ROOT), workload, ROOT), dtype)


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels run only on the card")
    return torch.device("cuda")
