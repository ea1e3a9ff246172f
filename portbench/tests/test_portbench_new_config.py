"""A transfer configuration and a transfer mix are added as files and entries
alone. A copy of the benchmark gains a Gatys configuration over every tap
(``gatys: true``, ``stack: null``, content tap 25, as ``methods.py --gatys
--cont_lyrs 25``) with a cell on the ``exact15s`` mix, and a scan mix
(``scan_window``, ``trace_maxiter``: a minute of audio against one global
gram, ``cli/transfer.py --exact --scan_window 32768``) with a cell of the
stack-0 configuration, with no edit to a file that was there. Both cells run
small on the CPU through ``portbench.run``; the reference's Gatys targets and
loss hold to the program's ``transfer_loss(gatys=True)`` on seeded weights;
the scan's faults and its control come out not correct."""

from __future__ import annotations

import json
import shutil

import numpy as np
import pytest
import torch

from portbench import spec, traffic_gen
from portbench.calibrate import control_transfer, planted
from portbench.common import model_config, rel_l2
from portbench.reference import nsynth
from portbench.reference.transfer import Loss, statistic_shape, style_taps
from portbench.run import judge, run_cell
from portbench.tests.conftest import ROOT, small
from portbench.tests.test_portbench_data import _digests
from portbench.weights import make_params

S0 = "nsynth-encoder-transfer-s0-bf16"
GATYS = "nsynth-encoder-transfer-gatys-bf16"
GATYS_CELL = "transfer_gatys_exact15s"
SCAN_CELL = "transfer_exact60s_scan"
SCAN_MIX = {"kind": "transfer_exact", "content_samples": 960000, "style_samples": 81920,
            "style_window": 16384, "scan_window": 32768, "epochs": 1, "distinct": 4,
            "trace_maxiter": 1}
SCAN_METRICS = ("mfu.transfer", "device_idle.transfer", "launches_per_eval.transfer",
                "host_reads_per_eval.transfer", "eval_dispatch_ms.transfer")


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """{cell: Cell} of the two new cells, resolved from a copy of the
    benchmark that gained them."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _digests(root / "portbench")

    bench = json.loads((root / "BENCHMARK.json").read_text())
    pb = root / "portbench"
    base = json.loads((pb / f"configs/{S0}.json").read_text())
    (pb / f"configs/{GATYS}.json").write_text(
        json.dumps(dict(base, gatys=True, stack=None, cont_lyr_ids=[25])))
    (pb / "traffic/exact60s_scan.json").write_text(json.dumps(SCAN_MIX))
    for cell in (GATYS_CELL, SCAN_CELL):
        (pb / f"limits/{cell}.json").write_text((pb / "limits/transfer_exact15s.json").read_text())
    bench["configs"].append({"name": GATYS, "source": "x", "reduced": [], "why": "x",
                             "file": f"portbench/configs/{GATYS}.json"})
    bench["workloads"] += [
        {"name": GATYS_CELL, "config": GATYS, "traffic": "exact15s", "chips": 1, "why": "x"},
        {"name": SCAN_CELL, "config": S0, "traffic": "exact60s_scan", "chips": 1, "why": "x"}]
    next(m for m in bench["end_to_end"]
         if m["name"] == "transfer_evals_per_s")["workloads"] += [GATYS_CELL, SCAN_CELL]
    for m in bench["per_layer"]:
        if m["name"] in SCAN_METRICS:
            m["workloads"].append(SCAN_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    after = _digests(pb)
    assert all(after[p] == d for p, d in before.items()), "an existing file was edited"

    import portbench.spec as live

    old = live.HERE
    live.HERE = pb
    try:
        return {name: spec.resolve(json.loads((root / "BENCHMARK.json").read_text()), name, root)
                for name in (GATYS_CELL, SCAN_CELL)}
    finally:
        live.HERE = old


@pytest.fixture(scope="module")
def gatys_cell(cells):
    return cells[GATYS_CELL]


def test_the_gatys_cell_resolves_and_runs_small_on_the_cpu(gatys_cell):
    cfg = gatys_cell.config
    assert cfg["gatys"] is True and cfg["stack"] is None
    assert style_taps(cfg) == tuple(range(30))
    assert statistic_shape(cfg) == (30, 128, 128)
    assert [m["name"] for m in gatys_cell.end_to_end] == ["transfer_evals_per_s", "setup_s"]
    res = run_cell(small(gatys_cell), 2**40 + 11, 0.2, False, "cpu")
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"transfer_evals_per_s", "setup_s"}
    assert res["attempted"] >= 1 and res["failed"] == 0


def test_the_gatys_reference_matches_the_program(gatys_cell):
    from audio_style_transfer_tpu_torch.transfer.grams import l2_normalize
    from audio_style_transfer_tpu_torch.transfer.losses import transfer_embeds, transfer_loss

    cell = small(gatys_cell)
    cfg = cell.config
    work = cell.kind.Workload(cell, 13, "cpu")
    work.params = params = make_params(cfg, 13, "cpu", encoder_only=True)
    lspec = work._engine().loss_spec
    assert lspec.gatys and lspec.style_layer_ids == tuple(range(30))
    assert lspec.cont_lyr_ids == (25,)

    rng = traffic_gen.rng_for(13)
    content, style = traffic_gen.arpeggio(rng, 4096), traffic_gen.drone(rng, 8192)
    ref = Loss(params, cfg)
    phi_c, target = ref.targets(content, style, 4096)
    assert tuple(target.shape) == statistic_shape(cfg) == (30, 32, 32)

    mcfg = model_config(cfg)
    q = lambda a: torch.as_tensor(nsynth.mu_law_floor(a), dtype=torch.float32)[None]  # noqa: E731
    c_port, g_content = transfer_embeds(params, q(content), mcfg, lspec)
    grams = [transfer_embeds(params, q(style[i * 4096:(i + 1) * 4096]), mcfg, lspec)[1]
             for i in range(2)]
    target_port = l2_normalize(g_content + torch.stack(grams).mean(0) - g_content)
    assert rel_l2(c_port, phi_c) < 1e-5
    assert rel_l2(target_port, target) < 1e-5

    x = torch.as_tensor(np.linspace(-20, 20, 4096), dtype=torch.float32)
    want = ref(x, phi_c, target)
    got, parts = transfer_loss(params, x[None], c_port, target_port, mcfg, lspec)
    torch.testing.assert_close(got, want[0], rtol=1e-5, atol=0)
    torch.testing.assert_close(parts["style_loss"], want[2], rtol=1e-5, atol=0)


def test_the_style_taps_follow_the_configuration():
    cfg = json.loads((ROOT / "portbench/configs/nsynth-encoder-transfer-s0-bf16.json").read_text())
    assert style_taps(cfg) == tuple(range(10)) and statistic_shape(cfg) == (128, 10, 10)
    assert style_taps(dict(cfg, stack=2)) == tuple(range(20, 30))
    assert style_taps(dict(cfg, stack=None)) == tuple(range(30))
    picked = dict(cfg, style_lyr_ids=[3, 7], nb_channels=64)
    assert style_taps(picked) == (3, 7) and statistic_shape(picked) == (64, 2, 2)
    assert statistic_shape(dict(picked, gatys=True)) == (2, 128, 128)


def test_the_scan_cell_runs_small_on_the_cpu(cells):
    cell = small(cells[SCAN_CELL], "bfloat16")
    assert cell.traffic["scan_window"] == 4096 and cell.traffic["trace_maxiter"] == 1
    work = cell.kind.Workload(cell, 1, "cpu")
    # 9000 samples: 8704 valid rows at the scan's 512 quantum, 3 windows of 4096.
    assert (work.rows, work.t_total) == (8704, 12288)
    res = run_cell(cell, 2**40 + 13, 0.2, False, "cpu")
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"transfer_evals_per_s", "setup_s"}


def test_the_scan_cells_traced_run_reads_its_metrics(cells):
    res = run_cell(small(cells[SCAN_CELL], "bfloat16"), 2**40 + 15, 0.2, True, "cpu")
    assert res["correct"], res["checks"]
    # The CPU has no device operations: only the host's readings are there.
    assert {"mfu.transfer", "host_reads_per_eval.transfer",
            "eval_dispatch_ms.transfer"} <= set(res["metrics"]) <= set(SCAN_METRICS)


def test_the_traced_clip_runs_the_mixs_iterations(cells):
    cell = small(cells[SCAN_CELL])
    work = cell.kind.Workload(cell, 3, "cpu")
    work.params = make_params(cell.config, 3, "cpu", encoder_only=True)
    work.engine = work._engine()
    work.install_spans()
    try:
        assert work.trace_engine.spec.maxiter == 1 and work.engine.spec.maxiter == 20
    finally:
        work.uninstall_spans()


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_broken_scan_is_not_correct(cells, fault):
    with planted(fault):
        res = run_cell(small(cells[SCAN_CELL], "bfloat16"), 2**40 + 9, 0.2, False, "cpu")
    assert not res["correct"], res["checks"]


def test_the_scan_control_is_not_correct(cells):
    c = small(cells[SCAN_CELL])
    work = c.kind.Workload(c, 2**35 + 3, "cpu")
    work.clips = traffic_gen.clip_pairs(work.seed, c.traffic)
    ok, checks = judge(control_transfer(work, clips=1), c.limits)
    assert not ok, checks
