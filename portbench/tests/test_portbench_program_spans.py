"""The readers of the program's spans (``portbench/program_spans.py``) on a
made-up capture whose answers are known, and on one without the spans, as a
program that opens none gives.

The capture, in us: ``transfer.targets`` [0, 100); ``lbfgs.minimize`` [200,
1000) holding ``lbfgs.eval`` [210, 300) and [500, 600) and
``lbfgs.host_read`` [300, 400), [600, 700) and [800, 850). Kernels launched
at 50 (targets), 220 (eval), 450 (L-BFGS), 510 (eval), 750 (L-BFGS), and a
copy launched at 1100 in no span; the window is 1200 us and ends with the
copy.
"""

from __future__ import annotations

import pytest

from portbench import program_spans, spec
from portbench.trace import Trace

SPANS = [("transfer.targets", 0, 100), ("lbfgs.minimize", 200, 1000),
         ("lbfgs.eval", 210, 300), ("lbfgs.host_read", 300, 400),
         ("lbfgs.eval", 500, 600), ("lbfgs.host_read", 600, 700),
         ("lbfgs.host_read", 800, 850)]
# (launch ts, device start, duration, category)
OPS = [(50, 60, 50, "kernel"), (220, 230, 100, "kernel"), (450, 460, 20, "kernel"),
       (510, 520, 100, "kernel"), (750, 760, 30, "kernel"), (1100, 1150, 10, "gpu_memcpy")]
WINDOW_S = 1200e-6


def _events(with_spans: bool = True) -> list:
    events = []
    if with_spans:
        events += [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a, "dur": b - a}
                   for n, a, b in SPANS]
    for i, (launch, ts, dur, cat) in enumerate(OPS):
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                       "ts": launch, "dur": 4, "args": {"correlation": i + 1}})
        events.append({"ph": "X", "cat": cat, "name": f"op{i}", "ts": ts, "dur": dur,
                       "args": {"correlation": i + 1}})
    return events


def _trace(with_spans: bool = True) -> Trace:
    return Trace(_events(with_spans), WINDOW_S, units=2, context={})


# Gaps: [-40, 60) to the targets' kernel, [110, 230) and [480, 520) to the
# evaluations', [330, 460) and [620, 760) to L-BFGS's, [790, 1150) to the
# copy launched in no span.
IDLE = {"targets": 100.0, "eval": 160.0, "lbfgs": 270.0, "none": 360.0}

EXPECTED = {
    "host_reads_per_eval.transfer": 1.5,
    "host_read_ms.transfer": 0.125,
    "lbfgs_self_ms.transfer": 0.18,  # 800 us less 190 of evaluations, 250 of reads; / 2
    "eval_dispatch_ms.transfer": 0.095,
    "lbfgs_launches_per_eval.transfer": 1.0,
    "idle_lbfgs_ms.transfer": 0.135,
    "idle_eval_ms.transfer": 0.08,
    "targets_ms.transfer": 0.05,
}


def test_idle_is_put_down_to_the_span_that_launched_the_end_of_each_gap():
    t = _trace()
    idle = program_spans.idle_by_layer(t)
    assert idle == pytest.approx(IDLE)
    # The four parts sum to the capture's device idle.
    assert sum(idle.values()) == pytest.approx(t.window_s * 1e6 - t.busy_s * 1e6)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_each_reader_reads_the_known_answer(name):
    assert spec.metric_reader(name)(_trace()) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_each_reader_finds_nothing_without_the_spans(name):
    assert spec.metric_reader(name)(_trace(with_spans=False)) is None


def test_the_new_metrics_are_the_transfer_cells():
    bench = spec.load_benchmark(spec.HERE.parent)
    entries = {m["name"]: m for m in bench["per_layer"]}
    transfer = next(m for m in bench["end_to_end"] if m["name"] == "transfer_evals_per_s")
    for name in EXPECTED:
        m = entries[name]
        assert (m["source"], m["moves"]) == ("program_span", "transfer_evals_per_s")
        assert "transfer_exact15s" in m["workloads"]
        assert set(m["workloads"]) <= set(transfer["workloads"])
