"""Finds a cell's parts by the names in BENCHMARK.json.

A cell names a configuration (its JSON file, given in ``configs``) and a
traffic mix (``traffic/<mix>.json``). The mix's ``kind`` names the driver
that runs it (``kinds/<kind>.py``); the cell's limits are
``limits/<cell>.json``; each per-layer metric is read by
``metrics/<metric>.py``. Adding a cell, a mix, a configuration or a metric
adds files and entries and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: tuple   # metric entries of BENCHMARK.json this cell reports
    per_layer: tuple
    limits: dict

    @property
    def kind(self):
        return importlib.import_module(f"portbench.kinds.{self.traffic['kind']}")


def load_benchmark(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def resolve(bench: dict, workload: str, root: Path) -> Cell:
    """The cell ``workload`` of ``bench``, its files read from ``root``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; cells: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    # An end-to-end metric without ``workloads`` is every cell's; a per-layer
    # metric names its cells.
    e2e = tuple(m for m in bench["end_to_end"] if workload in m.get("workloads", (workload,)))
    per_layer = tuple(m for m in bench["per_layer"] if workload in m["workloads"])
    limits_file = HERE / "limits" / f"{workload}.json"
    limits = json.loads(limits_file.read_text()) if limits_file.exists() else {}
    return Cell(workload, int(w["chips"]), config, traffic, e2e, per_layer, limits)


def metric_reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def check_names(bench: dict) -> list[str]:
    """What in ``bench`` breaks the rules on names and units."""
    bad = []
    entries = ([("config", c) for c in bench["configs"]] + [("workload", w) for w in
               bench["workloads"]] + [("metric", m) for m in bench["end_to_end"] +
               bench["per_layer"]])
    for kind, e in entries:
        for key in ("name", "config", "traffic"):
            if key in e and not NAME.match(e[key]):
                bad.append(f"{kind} {key} {e[key]!r}")
        for key in e.get("reduced", ()):
            if not NAME.match(key):
                bad.append(f"{kind} reduced key {key!r}")
        if "unit" in e and not UNIT.match(e["unit"]):
            bad.append(f"{kind} unit {e['unit']!r}")
        for key in ("why", "layer", "source"):
            text = e.get(key, "x")
            if not 1 <= len(text) <= 200 or "\n" in text or "\t" in text:
                bad.append(f"{kind} {key} of {len(text)} characters")
    return bad
