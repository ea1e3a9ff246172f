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


def small_cell(workload: str, dtype: str = "float32"):
    cell = spec.resolve(spec.load_benchmark(ROOT), workload, ROOT)
    cfg = dict(cell.config, **SMALL, compute_dtype=dtype)
    traffic = dict(cell.traffic)
    if traffic["kind"] == "transfer_exact":
        cfg.update(cnt_channels=32, nb_channels=32, maxiter=20)
        traffic.update(content_samples=9000, style_samples=8192, style_window=4096, distinct=2,
                       epochs=2)
    else:
        cfg.update(total_batch_size=2, sample_length=1024, steps_per_call=4)
        traffic.update(batch=2, samples=1024, distinct=4)
    return dataclasses.replace(cell, config=cfg, traffic=traffic)


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels run only on the card")
    return torch.device("cuda")
