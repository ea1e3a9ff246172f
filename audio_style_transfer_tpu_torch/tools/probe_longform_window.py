"""Probe one window of the synthetic long-form clip on the GPU: how far does
the L-BFGS epoch get in bfloat16 and in float32, with the zoom and with the
Moré-Thuente line search, with and without the OT style target?

Run from the repository root on a machine with one CUDA device:

    python3 -m audio_style_transfer_tpu_torch.tools.probe_longform_window [window]

It builds the engine as the long-form CLI does (stack 0, gamma 1e-3, random
weights from seed 0, the clips of chip_smoke.py), computes the per-window
targets, and runs one epoch (maxiter 100, from the 1e-6 start) on the chosen
window (default 1). Prints evals, status and final loss per combination.
"""

from __future__ import annotations

import sys

import torch

import chip_smoke as cs  # the synthetic clips; found from the repository root
from audio_style_transfer_tpu_torch.models.wavenet_ae import WaveNetAEConfig, init_params
from audio_style_transfer_tpu_torch.signal.mu_law import mu_law_numpy
from audio_style_transfer_tpu_torch.transfer import lbfgs, longform
from audio_style_transfer_tpu_torch.transfer.engine import StyleTransfer, TransferSpec
from audio_style_transfer_tpu_torch.transfer.losses import transfer_loss


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("probe_longform_window: CUDA is not available")
    window = int(sys.argv[1]) if len(sys.argv) > 1 else 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0))
    params = init_params(0, WaveNetAEConfig())
    content = cs.synth_audio((cs.WINDOWS * cs.T + 1000) / 16000, kind="content")
    style = cs.synth_audio(1.1, kind="style")
    for dtype in ("bfloat16", "float32"):
        spec = TransferSpec(stack=0, batch_size=cs.T, epochs=1, gamma=1e-3, compute_dtype=dtype,
                            fused_encoder=True, write_artifacts=False, device="cuda")
        eng = StyleTransfer(spec, params)
        for ot in (8, None):
            phi_t = eng.get_style_phi(style)
            phi_s = eng.get_style_phi(content)
            if ot:
                phi_t = longform._ot_transform_gram(eng, style, content, phi_t, ot)
            wins = eng._tensor(mu_law_numpy(longform.chunk_audio(content, cs.T)))
            pc, ph = longform._window_targets(eng.params, wins, eng._tensor(phi_t),
                                              eng._tensor(phi_s), eng.cfg, eng.loss_spec)

            def vg(x):
                xv = x.detach().requires_grad_(True)
                loss, _ = transfer_loss(eng.params, xv[None, :], pc[window], ph[window],
                                        eng.cfg, eng.loss_spec)
                (g,) = torch.autograd.grad(loss, xv)
                return loss.detach(), g

            for ls in ("zoom", "mt"):
                x0 = torch.full((cs.T,), 1e-6, device="cuda")
                res = lbfgs.lbfgs_minimize(vg, x0, lbfgs.LBFGSOptions(
                    maxiter=100, line_search=ls, restart_on_ls_fail=False))
                print(f"{dtype} ot_components {ot} window {window} {ls}: status {res.status}, "
                      f"{res.n_iters} iterations, {res.n_evals} evals, f {float(res.f):.4f}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
