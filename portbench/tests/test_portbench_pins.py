"""What the two first cells resolve to, pinned: the transfer engine's spec,
each cell's small sizes, the counts at the cells' shapes and the reference's
transfer loss on a fixed small input. A change to the harness that makes room
for other cells keeps every one of these as it was."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from portbench import counts, spec, traffic_gen
from portbench.reference.transfer import Loss
from portbench.tests.conftest import ROOT, small_cell
from portbench.weights import make_params

EXACT15S_SPEC = {
    "savepath": "./data/out", "logdir": "./log", "figdir": "./data/fig", "stack": 0,
    "batch_size": 16384, "sr": 16000, "cont_lyr_ids": (29,), "nb_channels": 128,
    "cnt_channels": 128, "gatys": False, "style_lyr_ids": None, "epochs": 2, "lambd": 100.0,
    "gamma": 0.0, "maxiter": 100, "early_stop_evals": 0, "compute_dtype": "bfloat16",
    "fused_encoder": False, "chain_encoder": None, "fused_gram": None, "warm_start": False,
    "write_artifacts": False, "device": "cpu",
}
WIDTHS = {"ae_width": 32, "ae_bottleneck_width": 4, "num_layers": 2, "width": 16,
          "skip_width": 8, "compute_dtype": "float32"}
SMALL = {
    "transfer_exact15s": (
        dict(WIDTHS, cnt_channels=32, nb_channels=32, maxiter=20),
        {"content_samples": 9000, "style_samples": 8192, "style_window": 4096, "distinct": 2}),
    "train_32x6144": (
        dict(WIDTHS, total_batch_size=2, sample_length=1024, steps_per_call=4),
        {"batch": 2, "samples": 1024, "distinct": 4}),
}


def _resolve(name):
    return spec.resolve(spec.load_benchmark(ROOT), name, ROOT)


def _changed(small: dict, full: dict) -> dict:
    return {k: v for k, v in small.items() if full.get(k) != v}


def test_the_exact_cells_engine_spec():
    cell = _resolve("transfer_exact15s")
    work = cell.kind.Workload(cell, 7, "cpu")
    work.params = make_params(cell.config, 7, "cpu", encoder_only=True)
    assert dataclasses.asdict(work._engine().spec) == EXACT15S_SPEC
    assert dataclasses.asdict(work._engine(maxiter=1).spec) == dict(EXACT15S_SPEC, maxiter=1)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_small_sizes(name):
    cell, small = _resolve(name), small_cell(name)
    cfg, traffic = SMALL[name]
    assert _changed(small.config, cell.config) == cfg
    assert _changed(small.traffic, cell.traffic) == traffic
    assert _changed(small_cell(name, "bfloat16").config, cell.config) == \
        {k: v for k, v in cfg.items() if k != "compute_dtype"}


def test_the_counts_at_the_cells_shapes():
    transfer, train = _resolve("transfer_exact15s").config, _resolve("train_32x6144").config
    rows = 237568
    assert counts.trunk_eval_bound_s(rows, transfer, 30, 30) == 0.0031793763343283582
    assert counts.gram_eval_bound_s(rows, transfer, 1, 1) == 0.0005446640716417911
    assert counts.transfer_eval_ops(rows, transfer) == 1877737472000.0
    rows = 32 * 6144
    assert counts.train_model_ops(rows, train) == 72211671023616.0
    assert counts.train_flops(rows, train) == 96950682648576.0
    assert counts.products_bound_s(counts.decoder_products(rows, train), "bfloat16") == \
        0.10078309912965244


def test_the_reference_loss_on_a_fixed_input():
    cfg = small_cell("transfer_exact15s").config
    params = make_params(cfg, 5, "cpu", encoder_only=True)
    rng = traffic_gen.rng_for(5)
    content, style = traffic_gen.arpeggio(rng, 4096), traffic_gen.drone(rng, 8192)
    ref = Loss(params, cfg)
    phi_c, target = ref.targets(content, style, 4096)
    assert tuple(phi_c.shape) == (4096, 32) and tuple(target.shape) == (32, 10, 10)
    assert float(phi_c.double().norm()) == pytest.approx(7301.589451293169, rel=1e-6)
    assert float(target.double().sum()) == pytest.approx(236.516155336285, rel=1e-6)
    x = torch.as_tensor(np.linspace(-20, 20, 4096), dtype=torch.float32)
    got = [float(v) for v in ref(x, phi_c, target)]
    assert got == pytest.approx([3501.42041015625, 3364.8603515625, 1.365600824356079],
                                rel=1e-6)
