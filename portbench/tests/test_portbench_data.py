"""The harness is driven by data: a configuration, a traffic mix and a
per-layer metric are added as new files (and entries in BENCHMARK.json) in a
copy of the benchmark, and the harness finds them by name with no edit to a
file that was there. Also: names and units keep to the allowed characters,
and a run on a machine without a card fails and names it."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import spec
from portbench.tests.conftest import ROOT
from portbench.trace import Trace


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_config_mix_and_metric_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path / "portbench")

    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    cfg = json.loads((tmp_path / bench["configs"][0]["file"]).read_text())
    (tmp_path / "portbench/configs/nsynth-encoder-transfer-s1-bf16.json").write_text(
        json.dumps(dict(cfg, stack=1)))
    (tmp_path / "portbench/traffic/clip32k.json").write_text(json.dumps(
        {"kind": "transfer_exact", "content_samples": 32768, "style_samples": 81920,
         "style_window": 16384, "epochs": 3, "distinct": 8}))
    (tmp_path / "portbench/metrics/device_busy_ms.transfer.py").write_text(
        "def read(t):\n    return t.busy_s * 1e3 if t.ops else None\n")
    bench["configs"].append({"name": "nsynth-encoder-transfer-s1-bf16", "source": "x",
                             "file": "portbench/configs/nsynth-encoder-transfer-s1-bf16.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "transfer_s1_clip32k",
                               "config": "nsynth-encoder-transfer-s1-bf16",
                               "traffic": "clip32k", "chips": 1, "why": "x"})
    bench["end_to_end"][0]["workloads"].append("transfer_s1_clip32k")
    bench["per_layer"].append({"name": "device_busy_ms.transfer", "unit": "ms",
                               "better": "lower", "source": "device_trace", "layer": "device",
                               "moves": "transfer_evals_per_s",
                               "workloads": ["transfer_s1_clip32k"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    after = _digests(tmp_path / "portbench")
    assert all(after[p] == d for p, d in before.items()), "an existing file was edited"

    import portbench.spec as live

    old = live.HERE
    live.HERE = tmp_path / "portbench"
    try:
        cell = spec.resolve(json.loads((tmp_path / "BENCHMARK.json").read_text()),
                            "transfer_s1_clip32k", tmp_path)
        reader = spec.metric_reader("device_busy_ms.transfer")
    finally:
        live.HERE = old
    assert cell.config["stack"] == 1 and cell.traffic["content_samples"] == 32768
    assert cell.kind.__name__ == "portbench.kinds.transfer_exact"
    assert [m["name"] for m in cell.end_to_end] == ["transfer_evals_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["device_busy_ms.transfer"]
    event = {"cat": "kernel", "name": "k", "ts": 0.0, "dur": 250.0, "args": {"correlation": 1}}
    assert reader(Trace([event], 1.0, 1, {})) == pytest.approx(0.25)
    assert reader(Trace([], 1.0, 1, {})) is None


def test_every_cell_resolves_and_every_metric_has_its_reader():
    bench = spec.load_benchmark(ROOT)
    for w in bench["workloads"]:
        cell = spec.resolve(bench, w["name"], ROOT)
        assert cell.limits, f"{cell.name} has no limits file"
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert callable(spec.metric_reader(m["name"]))
        assert cell.kind.Workload


def test_names_and_units_keep_to_the_allowed_characters():
    bench = spec.load_benchmark(ROOT)
    assert spec.check_names(bench) == []
    assert len(json.dumps(bench)) < 64 * 1024
    bad = dict(bench, per_layer=[dict(bench["per_layer"][0], unit="launches per evaluation",
                                      name="a b")])
    assert len(spec.check_names(bad)) == 2


def test_a_run_without_a_card_fails_and_names_it():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                           "transfer_exact15s", "--seed", "3000000000", "--seconds", "1",
                           "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert "CUDA card" in proc.stderr
    assert proc.stdout.strip() == ""
