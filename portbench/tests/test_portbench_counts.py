"""The frozen counts: bytes and operations per launch of K1, K2, K5 and K6,
the model's operations per evaluation and per training step, and the copied
``train_flops``, pinned to the numbers PERF.md's kernel table gives."""

from __future__ import annotations

import json

import pytest

from portbench import counts
from portbench.tests.conftest import ROOT

TRANSFER = json.loads((ROOT / "portbench/configs/nsynth-encoder-transfer-s0-bf16.json").read_text())
TRAIN = json.loads((ROOT / "portbench/configs/nsynth-ae-train-bf16.json").read_text())
T, C = 16384, 128


@pytest.mark.parametrize("kernel, dtype, bound_ms, by", [
    ("K1", "bfloat16", 0.0032, "bytes"), ("K1", "float32", 0.0321, "ops"),
    ("K2", "bfloat16", 0.0042, "bytes"), ("K2", "float32", 0.0321, "ops"),
    ("K5", "bfloat16", 0.0377, "bytes"), ("K5", "float32", 0.0753, "bytes"),
    ("K6", "bfloat16", 0.0753, "bytes"), ("K6", "float32", 0.1504, "bytes"),
])
def test_kernel_bounds_per_launch(kernel, dtype, bound_ms, by):
    nbytes, ops = {
        "K1": lambda: counts.k1(T, C, dtype),
        # chip_smoke's K2 bound: the tap cotangent on 10 of 30 layers.
        "K2": lambda: tuple(a / 3 + 2 * b / 3 for a, b in zip(counts.k2(T, C, dtype, True),
                                                              counts.k2(T, C, dtype, False))),
        "K5": lambda: counts.k5(T, C, 30, dtype),
        "K6": lambda: counts.k6(T, C, 30, dtype),
    }[kernel]()
    assert counts.bound_s(nbytes, ops, dtype) * 1e3 == pytest.approx(bound_ms, abs=5e-5)
    by_bytes = nbytes / counts.PEAK_BYTES_S >= ops / counts.PEAK_OPS_S[dtype]
    assert by_bytes == (by == "bytes")


def test_transfer_model_operations():
    trunk = 2 * counts.trunk_fwd_ops_per_row(TRANSFER)
    assert trunk == pytest.approx(7.86e6, rel=1e-3)
    assert trunk * T == pytest.approx(128.8e9, rel=1e-3)
    assert counts.transfer_eval_ops(T, TRANSFER) == pytest.approx(129.5e9, rel=1e-3)
    assert counts.transfer_eval_ops(237568, TRANSFER) == pytest.approx(1.877e12, rel=1e-3)


def test_training_model_operations_and_the_work_done():
    rows = 32 * 6144
    assert counts.train_model_ops(1, TRAIN) == pytest.approx(367.3e6, rel=1e-3)
    assert counts.train_model_ops(rows, TRAIN) == pytest.approx(72.2e12, rel=1e-3)
    assert counts.train_flops(rows, TRAIN) == pytest.approx(96.95e12, rel=1e-3)


def test_decoder_products_count_the_remat_forward_once_more():
    rows, w = 32 * 6144, TRAIN["width"]
    flops = sum(2.0 * m * k * n * c for m, k, n, c in counts.decoder_products(rows, TRAIN))
    block, dec = counts._decoder_fwd_ops_per_row(TRAIN)
    # The decoder's forward, backward (2x) and the blocks' re-forward, less
    # the start conv (one input channel: no product) and the backward of the
    # last block's residual (no gradient reaches it); plus the bottleneck's
    # three products and the conditioning's, at one row per hop.
    start = 3 * 2.0 * 3 * w
    last_res = 2 * 2.0 * w * w
    bottleneck = 3 * 2.0 * 128 * 16
    cond = 2.0 * 16 * (2 * w * 30 * 4 + 256 * 3) / 512
    want = (3 * dec + block - start - last_res + bottleneck + cond) * rows
    assert flops == pytest.approx(want, rel=1e-12)
