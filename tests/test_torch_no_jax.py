"""The port imports no JAX and nothing of the JAX package (at import, in a
CLI run, or in its source), builds nothing at import, and chip_smoke.py
refuses to run without a GPU.

Subprocesses, because tests/conftest.py imports jax into this process.
"""

import glob
import os
import re
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = [
    "audio_style_transfer_tpu_torch",
    "audio_style_transfer_tpu_torch.utils.audio_io",
    "audio_style_transfer_tpu_torch.utils.paths",
    "audio_style_transfer_tpu_torch.utils.profiling",
    "audio_style_transfer_tpu_torch.analysis.spectrogram",
    "audio_style_transfer_tpu_torch.analysis.viz",
    "audio_style_transfer_tpu_torch.analysis.nmf",
    "audio_style_transfer_tpu_torch.analysis.ot",
    "audio_style_transfer_tpu_torch.analysis.summaries",
    "audio_style_transfer_tpu_torch.analysis.rainbow",
    "audio_style_transfer_tpu_torch.signal.mu_law",
    "audio_style_transfer_tpu_torch.signal.stft",
    "audio_style_transfer_tpu_torch.signal.specgram",
    "audio_style_transfer_tpu_torch.signal.cqt",
    "audio_style_transfer_tpu_torch.signal.cqt_multirate",
    "audio_style_transfer_tpu_torch.ops.conv",
    "audio_style_transfer_tpu_torch.ops._build",
    "audio_style_transfer_tpu_torch.ops.chain",
    "audio_style_transfer_tpu_torch.ops.encoder",
    "audio_style_transfer_tpu_torch.ops.gram",
    "audio_style_transfer_tpu_torch.models.wavenet_ae",
    "audio_style_transfer_tpu_torch.models.baseline_ae",
    "audio_style_transfer_tpu_torch.ckpt.convert",
    "audio_style_transfer_tpu_torch.transfer.grams",
    "audio_style_transfer_tpu_torch.transfer.losses",
    "audio_style_transfer_tpu_torch.transfer.lbfgs",
    "audio_style_transfer_tpu_torch.transfer.engine",
    "audio_style_transfer_tpu_torch.transfer.longform",
    "audio_style_transfer_tpu_torch.transfer.scipy_parity",
    "audio_style_transfer_tpu_torch.transfer.composed_parity",
    "audio_style_transfer_tpu_torch.parallel",
    "audio_style_transfer_tpu_torch.parallel.halo",
    "audio_style_transfer_tpu_torch.parallel.mesh",
    "audio_style_transfer_tpu_torch.parallel.tensor",
    "audio_style_transfer_tpu_torch.cli.transfer",
    "audio_style_transfer_tpu_torch.generate",
    "audio_style_transfer_tpu_torch.generate.fastgen",
    "audio_style_transfer_tpu_torch.cli.generate",
    "audio_style_transfer_tpu_torch.cli.save_embeddings",
    "audio_style_transfer_tpu_torch.data",
    "audio_style_transfer_tpu_torch.data.tfrecord",
    "audio_style_transfer_tpu_torch.data.native",
    "audio_style_transfer_tpu_torch.data.nsynth",
    "audio_style_transfer_tpu_torch.train",
    "audio_style_transfer_tpu_torch.train.optimizers",
    "audio_style_transfer_tpu_torch.train.trainer",
    "audio_style_transfer_tpu_torch.cli.train",
    "audio_style_transfer_tpu_torch.cli.baseline_train",
    "audio_style_transfer_tpu_torch.cli.baseline_save_embeddings",
    "audio_style_transfer_tpu_torch.cli.output_grams",
    "chip_smoke",
]


def _run(code, cwd=REPO, args=()):
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", code, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax_and_builds_nothing(tmp_path):
    """Every module of the port, then a one-epoch CPU run of its CLI, one
    of its ``--exact`` mode, a run of the generate CLI on one frame and one
    step of the train CLI on a synthetic TFRecord, in one subprocess: no
    JAX, no module of the JAX package, no kernel library."""
    code = (
        "import importlib, sys, wave\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(2)\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "from audio_style_transfer_tpu_torch.ops import _build\n"
        "assert _build._lib is None, 'a kernel library was loaded at import'\n"
        "def foreign():\n"
        "    return [m for m in sys.modules if m in ('jax', 'jaxlib', 'triton', 'matplotlib',\n"
        "            'tensorflow',\n"
        "            'audio_style_transfer_tpu') or m.startswith('audio_style_transfer_tpu.')]\n"
        "assert not foreign(), ('imported', foreign())\n"
        "tmp = sys.argv[1]\n"
        "for name, f in (('tone', 220.0), ('square', 330.0)):\n"
        "    x = 0.5 * np.sin(2 * np.pi * f * np.arange(9600) / 16000.0)\n"
        "    with wave.open(f'{tmp}/{name}.wav', 'wb') as w:\n"
        "        w.setnchannels(1); w.setsampwidth(2); w.setframerate(16000)\n"
        "        w.writeframes((x * 32767.0).astype('<i2').tobytes())\n"
        "from audio_style_transfer_tpu_torch.cli.transfer import main\n"
        "main(['tone', 'square', '--dir', tmp, '--outdir', tmp + '/out', '--logdir',\n"
        "      tmp + '/log', '--device', 'cpu', '--random_init', '--no_artifacts', '--stack',\n"
        "      '0', '--batch_size', '4096', '--epochs', '1', '--maxiter', '2', '--start', '0.1'])\n"
        "main(['tone', 'square', '--dir', tmp, '--outdir', tmp + '/out', '--logdir',\n"
        "      tmp + '/log', '--device', 'cpu', '--random_init', '--no_artifacts', '--stack',\n"
        "      '0', '--batch_size', '4096', '--epochs', '1', '--maxiter', '1', '--exact'])\n"
        "from audio_style_transfer_tpu_torch.models.wavenet_ae import init_params\n"
        "np.savez(tmp + '/w.npz', **{f'{k}/{m}': v.numpy() for k, e in init_params(0).items()\n"
        "                            for m, v in e.items()})\n"
        "from audio_style_transfer_tpu_torch.cli import generate\n"
        "generate.main(['--source_path', tmp + '/tone.wav', '--save_path', tmp + '/gen',\n"
        "               '--checkpoint_path', tmp + '/w.npz', '--device', 'cpu',\n"
        "               '--sample_length', '512'])\n"
        "from audio_style_transfer_tpu_torch.data import build_example, write_tfrecord\n"
        "write_tfrecord(tmp + '/t.tfrecord', [build_example({'pitch': np.array([60]),\n"
        "    'audio': np.random.RandomState(0).uniform(-0.5, 0.5, 1024).astype('float32')})])\n"
        "from audio_style_transfer_tpu_torch.cli import train\n"
        "train.main(['--train_path', tmp + '/t.tfrecord', '--logdir', tmp + '/tlog',\n"
        "            '--total_batch_size', '1', '--sample_length', '512', '--num_iters', '1',\n"
        "            '--device', 'cpu'])\n"
        "bad = [m for m in foreign() if m != 'matplotlib']\n"
        "print('imported:', bad)\n"
        "sys.exit(1 if bad or _build._lib is not None else 0)\n"
    )
    r = _run(code, args=(str(tmp_path),))
    assert r.returncode == 0, r.stdout + r.stderr[-2000:]
    assert "optimized 1 epochs" in r.stdout
    assert "optimized 0.5s of audio" in r.stdout
    assert "generated 1 file(s)" in r.stdout
    assert "ckpt-1 at step 1" in r.stdout


def test_port_sources_name_no_module_of_the_jax_package():
    """No source of the port, not chip_smoke.py and not the port's examples
    (examples/*_torch.py) holds an import of jax or of the JAX package, in
    any of the three forms."""
    forms = re.compile(
        r"^\s*(import\s+audio_style_transfer_tpu(\.|\s|$)"
        r"|from\s+audio_style_transfer_tpu(\.[\w.]*)?\s+import"
        r"|import\s+jax\b|from\s+jax\b)", re.M)
    files = glob.glob(os.path.join(REPO, "audio_style_transfer_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
    examples = glob.glob(os.path.join(REPO, "examples", "*_torch.py"))
    assert len(files) > 20 and len(examples) == 2
    files += examples
    hits = []
    for path in files:
        with open(path) as f:
            hits += [(os.path.relpath(path, REPO), m.group(0).strip())
                     for m in forms.finditer(f.read())]
    assert not hits, hits


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
