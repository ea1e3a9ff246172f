"""Each cell at its own size on the card, one short window: the run is
correct and reports every end-to-end metric (skips without a card)."""

from __future__ import annotations

import pytest

from portbench import spec
from portbench.run import run_cell
from portbench.tests.conftest import ROOT

CELLS = [w["name"] for w in spec.load_benchmark(ROOT)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card_is_correct(card, name):
    cell = spec.resolve(spec.load_benchmark(ROOT), name, ROOT)
    res = run_cell(cell, 2**31 + 17, 2.0, False, str(card))
    assert res["correct"], res["checks"]
    assert {m["name"] for m in cell.end_to_end} == set(res["metrics"])
    assert res["device"]["platform"] == "gpu"
