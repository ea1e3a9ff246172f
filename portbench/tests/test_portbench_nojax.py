"""Nothing a cell runs loads JAX or the JAX package, and the reference loads
nothing of the program. Module names are compared by their whole top-level
name: the port's own name begins with the JAX package's."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench import spec
from portbench.run import FORBIDDEN
from portbench.tests.conftest import ROOT

CELLS = [w["name"] for w in spec.load_benchmark(ROOT)["workloads"]]

RUN_SMALL = """
import json, sys
from portbench.tests.conftest import small_cell
from portbench.run import run_cell
run_cell(small_cell({cell!r}), 5, 0.2, {trace}, "cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code: str) -> set[str]:
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_loads_neither_jax_nor_the_jax_package(cell):
    loaded = _top_level(RUN_SMALL.format(cell=cell, trace=True))
    assert "audio_style_transfer_tpu_torch" in loaded
    assert not loaded & set(FORBIDDEN), sorted(loaded & set(FORBIDDEN))


def test_the_reference_loads_nothing_of_the_program():
    loaded = _top_level(
        "import json, sys\n"
        "import portbench.reference.nsynth, portbench.reference.transfer\n"
        "import portbench.reference.train, portbench.reference.lowp\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    assert "portbench" in loaded
    assert not loaded & {"audio_style_transfer_tpu_torch", *FORBIDDEN}


def test_the_check_compares_whole_top_level_names():
    from portbench import run

    saved = dict(sys.modules)
    try:
        sys.modules["audio_style_transfer_tpu_torch_x"] = sys
        assert "audio_style_transfer_tpu" not in run.forbidden_modules()
        sys.modules["audio_style_transfer_tpu.cli"] = sys
        assert run.forbidden_modules() == ["audio_style_transfer_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
