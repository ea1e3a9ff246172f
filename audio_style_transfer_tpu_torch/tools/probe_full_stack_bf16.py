"""Probe the full-stack CLI run of chip_smoke.py on the GPU: how much does its
L-BFGS trajectory depend on the last bits of the gram?

Run from the repository root on a machine with one CUDA device:

    python3 -m audio_style_transfer_tpu_torch.tools.probe_full_stack_bf16

It runs the transfer CLI as chip_smoke.py's full-stack path does (style taps
0..29, `--cont_lyrs 25`, 3 epochs, random weights from seed 0, the synthetic
clips) in bfloat16 and in float32, with the gram forward and backward each
taken from the kernels (K5, K6) or from their plain versions, and then three
times in bfloat16 with the kernels and every gram entry scaled by 1 + 1e-6 of
seeded noise (less than the float32 sums of two summation orders differ by).
Prints evals, loss, content and style per epoch for each run, with the card's
name and power limit.
"""

from __future__ import annotations

import contextlib
import io
import os
import re
import subprocess
import sys
import tempfile

import torch

import chip_smoke as cs  # the synthetic clips; found from the repository root
from audio_style_transfer_tpu_torch.cli.transfer import main as cli_main
from audio_style_transfer_tpu_torch.ops import gram


def run(label: str, precision: str, fwd, bwd) -> None:
    """One CLI run with ``gram.pair_gram_fwd`` / ``pair_gram_bwd`` replaced."""
    originals = (gram.pair_gram_fwd, gram.pair_gram_bwd)
    gram.pair_gram_fwd, gram.pair_gram_bwd = fwd, bwd
    try:
        with tempfile.TemporaryDirectory() as tmp:
            src = os.path.join(tmp, "src")
            os.makedirs(src)
            cs.write_wav(os.path.join(src, "content.wav"), cs.synth_audio(3.0, kind="content"))
            cs.write_wav(os.path.join(src, "style.wav"), cs.synth_audio(3.0, kind="style"))
            argv = ["content", "style", "--dir", src, "--outdir", os.path.join(tmp, "out"),
                    "--logdir", os.path.join(tmp, "log"), "--cont_lyrs", "25",
                    "--precision", precision, "--fused", "--random_init", "--no_artifacts",
                    "--epochs", "3", "--device", "cuda"]
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cli_main(argv)
    finally:
        gram.pair_gram_fwd, gram.pair_gram_bwd = originals
    rows = re.findall(r"Ep \d+/\d+ - evals (\d+) - loss (\S+) - content (\S+) - style (\S+)",
                      buf.getvalue())
    epochs = "; ".join(f"evals {e} loss {lo} content {c} style {s}" for e, lo, c, s in rows)
    print(f"[{precision}, {label}] {epochs}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("probe_full_stack_bf16: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0])
    k5, k6 = gram.pair_gram_fwd, gram.pair_gram_bwd
    plain_fwd, plain_bwd = gram.pair_gram_reference, gram.pair_gram_bwd_plain
    for precision in ("bfloat16", "float32"):
        run("K5 + K6", precision, k5, k6)
        run("plain forward + K6", precision, plain_fwd, k6)
        run("K5 + plain backward", precision, k5, plain_bwd)
        run("plain forward + plain backward", precision, plain_fwd, plain_bwd)

    gen = torch.Generator(device="cuda").manual_seed(0)

    def noisy_k5(*taps):
        g = k5(*taps)
        return g * (1 + 1e-6 * torch.randn(g.shape, generator=gen, device=g.device))

    for i in range(3):
        run(f"K5 x (1 + 1e-6 noise) + K6, draw {i}", "bfloat16", noisy_k5, k6)
    return 0


if __name__ == "__main__":
    sys.exit(main())
