"""The port imports no JAX, builds nothing at import, and chip_smoke.py
refuses to run without a GPU.

Subprocesses, because tests/conftest.py imports jax into this process.
"""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = [
    "audio_style_transfer_tpu_torch",
    "audio_style_transfer_tpu_torch.signal.mu_law",
    "audio_style_transfer_tpu_torch.ops.conv",
    "audio_style_transfer_tpu_torch.ops._build",
    "audio_style_transfer_tpu_torch.ops.chain",
    "audio_style_transfer_tpu_torch.ops.gram",
    "audio_style_transfer_tpu_torch.models.wavenet_ae",
    "audio_style_transfer_tpu_torch.ckpt.convert",
    "audio_style_transfer_tpu_torch.transfer.grams",
    "audio_style_transfer_tpu_torch.transfer.losses",
    "audio_style_transfer_tpu_torch.transfer.lbfgs",
    "audio_style_transfer_tpu_torch.transfer.engine",
    "audio_style_transfer_tpu_torch.cli.transfer",
    "chip_smoke",
]


def _run(code, cwd=REPO, args=()):
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", code, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax_and_builds_nothing():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "from audio_style_transfer_tpu_torch.ops import _build\n"
        "assert _build._lib is None, 'a kernel library was loaded at import'\n"
        "bad = [m for m in ('jax', 'jaxlib', 'triton', 'matplotlib') if m in sys.modules]\n"
        "print('imported:', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = _run(code)
    assert r.returncode == 0, r.stdout + r.stderr[-2000:]


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu_or_repo(where, tmp_path):
    """No GPU here: the script must exit non-zero and print no result line.
    Copied alone into an empty directory, it must fail the same way."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
