"""The comparison that decides ``correct`` fails what it must: a whole run of
each cell, at a size the CPU holds and past the look for a card, with the
timed path broken underneath (each fault the cell can have), and the
control: the reference put in the program's place in fp8. A sound run of
the same size comes out correct."""

from __future__ import annotations

import pytest
from portbench.calibrate import control_train, control_transfer, planted
from portbench.run import judge, run_cell
from portbench.tests.conftest import small_cell


@pytest.mark.parametrize("cell", ["transfer_exact15s", "train_32x6144"])
def test_a_sound_run_is_correct(cell):
    res = run_cell(small_cell(cell, "bfloat16"), 2**40 + 3, 0.2, False, "cpu")
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_broken_transfer_is_not_correct(fault):
    with planted(fault):
        res = run_cell(small_cell("transfer_exact15s", "bfloat16"), 2**40 + 5, 0.2, False, "cpu")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_broken_training_step_is_not_correct(fault):
    with planted(fault):
        res = run_cell(small_cell("train_32x6144", "bfloat16"), 2**40 + 7, 0.2, False, "cpu")
    assert not res["correct"], res["checks"]


def test_the_transfer_control_is_not_correct():
    c = small_cell("transfer_exact15s")
    work = c.kind.Workload(c, 2**35 + 1, "cpu")
    from portbench import traffic_gen

    work.clips = traffic_gen.clip_pairs(work.seed, c.traffic)
    ok, checks = judge(control_transfer(work, clips=1), c.limits)
    assert not ok, checks


def test_the_training_control_is_not_correct():
    c = small_cell("train_32x6144")
    work = c.kind.Workload(c, 2**35 + 2, "cpu")
    from portbench import traffic_gen

    work.batches = traffic_gen.tone_batches(work.seed, c.traffic)
    ok, checks = judge(control_train(work), c.limits)
    assert not ok, checks
