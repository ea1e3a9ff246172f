"""Style-transfer CLI (counterpart of audio_style_transfer_tpu/cli/transfer.py).

The same parser and flags as the JAX CLI, plus ``--device`` (default
``cuda``). Usage:
    python -m audio_style_transfer_tpu_torch.cli.transfer pachelbel organ \
        --epochs 100 --stack 0 --precision bfloat16

Leaving out ``--stack`` takes the style grams over all 30 trunk taps (the
full-stack transfer, e.g. ``--cont_lyrs 25``). On CUDA the trunk and gram
kernels always run, on the CPU their plain versions; ``--fused`` keeps the
chained trunk, as the JAX CLI does (it leaves ``chain_encoder`` unset).
``--longform`` transfers the whole content clip window by window
(``--ot_components``/``--ot_blend`` add the NMF + optimal-transport style
target) and writes ``longform.wav``; ``--exact`` optimizes one global window
over the whole clip instead (``--scan_window N`` runs it as a scan over
N-sample windows; transfer/longform.py::transfer_exact).
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("cont_fn", help="relative content file name")
    parser.add_argument("style_fn", help="relative style file name")
    parser.add_argument(
        "--epochs",
        help="number of epochs, each epoch contains 100 iterations of optimization",
        nargs="?", type=int, default=100,
    )
    parser.add_argument(
        "--maxiter",
        help="L-BFGS iteration budget per epoch (extension flag: the "
             "reference hardcodes 100 at methods.py:137)",
        nargs="?", type=int, default=100,
    )
    parser.add_argument(
        "--batch_size",
        help="length of output signal, must be divided by 4096",
        nargs="?", type=int, default=16384,
    )
    parser.add_argument("--sr", help="sampling rate, default to 16kHz",
                        nargs="?", type=int, default=16000)
    parser.add_argument(
        "--stack",
        help="stack of layers chosen for computing style loss. Have effects "
        "only if style_lyrs is None. There are 3 stacks, each of 10 layers. "
        "If None then all three stacks will be taken into account",
        nargs="?", type=int, default=None,
    )
    parser.add_argument("--cont_lyrs", nargs="*", type=int, default=[29])
    parser.add_argument("--style_lyrs", nargs="*", type=int)
    parser.add_argument("--lambd", help="style loss scalar coefficient",
                        nargs="?", type=float, default=100.0)
    parser.add_argument("--gamma", help="regularizer scalar coefficient",
                        nargs="?", type=float, default=0.0)
    parser.add_argument(
        "--channels", help="how many channels taken into account for style loss",
        nargs="?", type=int, default=128,
    )
    parser.add_argument(
        "--cnt_channels",
        help="how many channels taken into account for content loss",
        nargs="?", type=int, default=128,
    )
    parser.add_argument("--start", nargs="?", type=float, default=1.0)
    parser.add_argument("--gatys", nargs="?", type=bool, default=False, const=True)
    parser.add_argument(
        "--ckpt_path", help="path to the pretrained model's checkpoint path",
        nargs="?", default="./nsynth/model/wavenet-ckpt/model.ckpt-200000",
    )
    parser.add_argument(
        "--dir",
        help="path to source files, should be where to store reference style "
        "and content files",
        nargs="?", default="./data/src",
    )
    parser.add_argument("--outdir", help="path to output", nargs="?",
                        default="./data/out")
    parser.add_argument("--logdir", help="path to logs", nargs="?", default="./log")
    parser.add_argument("--cmt")
    # --- extensions shared with the JAX CLI ---
    parser.add_argument("--precision", choices=["float32", "bfloat16"],
                        default="float32", help="encoder compute dtype")
    parser.add_argument("--fused", action="store_true",
                        help="accepted for parity: the chained trunk runs either way, "
                             "and the device selects kernels or plain versions")
    parser.add_argument("--no_artifacts", action="store_true",
                        help="skip per-epoch wav/figure dumps")
    parser.add_argument("--warm_start", action="store_true",
                        help="carry L-BFGS curvature memory across epochs")
    parser.add_argument("--random_init", action="store_true",
                        help="random weights instead of pretrained (smoke runs)")
    parser.add_argument("--longform", action="store_true",
                        help="chunked long-form mode: transfer the whole "
                             "content clip window-by-window (transfer/longform.py)")
    parser.add_argument("--ot_components", nargs="?", type=int, default=None,
                        help="(longform/exact) apply the NMF+OT palette transform to "
                             "the style target with this many components")
    parser.add_argument("--ot_blend", nargs="?", type=float, default=0.5,
                        help="(longform/exact) weight of the OT translated-gram "
                             "correction on the style target (0 = reference "
                             "target, 1 = full correction)")
    parser.add_argument("--exact", action="store_true",
                        help="exact long-form mode: one global window over the "
                             "whole clip (no chunk seams, one global gram), on "
                             "one device (transfer/longform.transfer_exact)")
    parser.add_argument("--scan_window", nargs="?", type=int, default=None,
                        help="(exact) window size of the scan; live memory "
                             "scales with it, numerics do not. Default: clips up "
                             "to about 2 minutes run as one unmasked trunk pass, "
                             "longer clips scan in 32768-sample windows")
    # --- port-only ---
    parser.add_argument("--device", default="cuda",
                        help="torch device the transfer runs on (cuda or cpu)")
    return parser


def get_dir(directory: str, args) -> str:
    """The run's artifact directory, named as the JAX CLI names it."""
    from audio_style_transfer_tpu_torch.utils.paths import crt_t_fol, gt_s_path

    kwargs = {
        k: v
        for k, v in vars(args).items()
        if k not in ("precision", "no_artifacts", "random_init", "fused",
                     "warm_start", "longform", "ot_components", "ot_blend",
                     "exact", "scan_window", "maxiter", "device")
    }
    if getattr(args, "longform", False) or getattr(args, "exact", False):
        if getattr(args, "longform", False):
            kwargs["longform"] = True
        if getattr(args, "exact", False):
            kwargs["exact"] = True
        if args.ot_components is not None:
            kwargs["n_components"] = args.ot_components
            kwargs["otblend"] = args.ot_blend
    if getattr(args, "maxiter", 100) != 100:
        kwargs["maxiter"] = args.maxiter
    if getattr(args, "warm_start", False):
        kwargs["warm"] = True
    return gt_s_path(crt_t_fol(directory), **kwargs)


def piece_work(args):
    """Orchestrate one transfer run (reference methods.py:227-240)."""
    from audio_style_transfer_tpu_torch.models.wavenet_ae import (
        WaveNetAEConfig,
        init_params,
    )
    from audio_style_transfer_tpu_torch.transfer.engine import StyleTransfer, TransferSpec

    savepath = get_dir(args.outdir, args)
    logdir = get_dir(args.logdir, args)
    figdir = os.path.join(savepath, "fig")
    os.makedirs(figdir, exist_ok=True)

    content = os.path.join(args.dir, args.cont_fn) + ".wav"
    style = os.path.join(args.dir, args.style_fn) + ".wav"

    if args.random_init:
        params = init_params(0, WaveNetAEConfig())
    else:
        from audio_style_transfer_tpu_torch.ckpt.convert import load_pretrained

        params = load_pretrained(args.ckpt_path)

    spec = TransferSpec(
        savepath=savepath,
        logdir=logdir,
        figdir=figdir,
        stack=args.stack,
        batch_size=args.batch_size,
        sr=args.sr,
        cont_lyr_ids=tuple(args.cont_lyrs),
        nb_channels=args.channels,
        cnt_channels=args.cnt_channels,
        gatys=bool(args.gatys),
        style_lyr_ids=tuple(args.style_lyrs) if args.style_lyrs else None,
        epochs=args.epochs,
        maxiter=args.maxiter,
        lambd=args.lambd,
        gamma=args.gamma,
        compute_dtype=args.precision,
        fused_encoder=args.fused,
        warm_start=args.warm_start,
        write_artifacts=not args.no_artifacts,
        device=args.device,
    )
    engine = StyleTransfer(spec, params)
    if args.longform or args.exact:
        return _run_longform(engine, args, content, style, savepath)
    return engine.run(content, content, style, epochs=args.epochs, start=args.start)


def _run_longform(engine, args, content: str, style: str, savepath: str):
    """The whole-clip runs behind --longform / --exact: the content file is
    transferred end to end (``--start`` windowing does not apply) and the
    waveform lands as longform.wav in the run directory."""
    import time

    import numpy as np

    from audio_style_transfer_tpu_torch.transfer.longform import (
        transfer_exact,
        transfer_longform,
    )
    from audio_style_transfer_tpu_torch.utils.audio_io import load_audio, write_wav

    # audio_channel=0 as engine.run and the reference (utils.py:260-264):
    # stereo files must collapse to 1-D or the chunker sees [channels, T].
    content_audio, _ = load_audio(content, sr=args.sr, audio_channel=0)
    style_audio, _ = load_audio(style, sr=args.sr, audio_channel=0)
    t0 = time.time()
    if args.exact:
        res = transfer_exact(engine, content_audio, style_audio, mesh=None,
                             epochs=args.epochs, scan_window=args.scan_window,
                             ot_components=args.ot_components, ot_blend=args.ot_blend)
    else:
        res = transfer_longform(engine, content_audio, style_audio, epochs=args.epochs,
                                ot_components=args.ot_components, ot_blend=args.ot_blend)
    evals = int(np.sum(res.per_window["evals"]))
    print(f"optimized {len(res.audio) / args.sr:.1f}s of audio "
          f"({evals} evals) in {time.time() - t0:.2f}s")
    if not args.no_artifacts:
        peak = float(np.max(np.abs(res.audio))) or 1.0
        write_wav(os.path.join(savepath, "longform.wav"), res.audio / peak, sr=args.sr)
    return res.audio


def main(argv=None):
    args = build_parser().parse_args(argv)
    return piece_work(args)


if __name__ == "__main__":
    main()
