"""The readings that a cell's limits are set from, on the card at the cell's
own size, in one process.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,... --seconds <s>
        [--control-seeds 7,8,9] [--faults half,altered,unchanged] [--out file.jsonl]

For each seed: the program's run (set-up, a window of ``--seconds``, the
numbers compared). For each control seed: the control, which is the
reference put in the program's place in fp8 (``reference.lowp.FP8``): the
targets, an L-BFGS run (``torch.optim.LBFGS``, strong Wolfe, the
configuration's maxiter, a cold restart each epoch) and the losses it
reports, or three training steps, judged as the program is. For each fault
and control seed: the program with the fault planted (``planted``), set up
and run for ``--fault-seconds``. Each reading is one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

from portbench import spec, traffic_gen
from portbench.common import sync
from portbench.reference import nsynth
from portbench.reference import train as ref_train
from portbench.reference.lowp import FP8
from portbench.reference.transfer import Loss
from portbench.run import ROOT, environment
from portbench.weights import make_params


def _lbfgs_epochs(loss: Loss, x0, phi_c, target, epochs: int, maxiter: int):
    """The control's optimizer: (snapshots, losses, evals) per epoch."""
    x = x0.clone().requires_grad_(True)
    snaps, losses, evals = [], [], []
    for _ in range(epochs):
        opt = torch.optim.LBFGS([x], lr=1.0, max_iter=maxiter, history_size=10,
                                line_search_fn="strong_wolfe")

        def closure():
            opt.zero_grad()
            value = loss(x, phi_c, target)[0]
            value.backward()
            return value

        opt.step(closure)
        evals.append(int(opt.state[opt._params[0]]["func_evals"]))
        with torch.no_grad():
            losses.append(float(loss(x, phi_c, target)[0]))
        snaps.append(x.detach().clone())
    return snaps, losses, evals


def control_transfer(work, clips: int) -> dict:
    """The fp8 reference in the program's place for ``clips`` clips: its
    targets and an L-BFGS run; judged by the cell's own ``readings``."""
    from portbench.kinds.transfer_exact import X0

    params = make_params(work.cfg, work.seed, work.device, encoder_only=True)
    loss = Loss(params, work.cfg, q=FP8)
    x0 = torch.full((work.rows,), X0, device=work.device)
    work.done = []
    with nsynth.float32_exact():
        for i in range(clips):
            content, style = work.clips[i]
            with torch.no_grad():
                phi_c, target = loss.targets(content[:work.rows], style, work.mix["style_window"])
            snaps, losses, evals = _lbfgs_epochs(loss, x0, phi_c, target, work.mix["epochs"],
                                                 work.cfg["maxiter"])
            work.done.append({"clip": i, "x": snaps[-1].cpu().numpy(), "losses": losses,
                              "evals": evals, "epochs_done": len(evals),
                              "probe": {"phi_c": phi_c.cpu(), "target": target.cpu()}})
    return work.readings()


def control_train(work) -> dict:
    from portbench.kinds.train_fit import FIRST_STEPS, _change_norms, _leaf_norms, compare

    params0 = make_params(work.cfg, work.seed, work.device)
    batches = torch.as_tensor(work.batches[:FIRST_STEPS], device=work.device)
    low = ref_train.follow(params0, batches, work.cfg, steps=FIRST_STEPS, q=FP8)
    ref = ref_train.follow(params0, batches, work.cfg, steps=FIRST_STEPS)
    p0 = ref_train.leaves(params0)
    first = {"losses": low["losses"], "grad1": _leaf_norms(low["grad1"]),
             "update": _change_norms(low["params"], p0), "ema": _change_norms(low["ema"], p0)}
    return compare(first, ref, p0)


@contextlib.contextmanager
def planted(fault: str):
    """A fault planted in the program for the duration: ``unchanged`` (a
    step that returns its state unchanged: L-BFGS hands back its start, the
    trainer's update is skipped), ``half`` (half of the batch left out, the
    mean taken over the rest: half of the clip's rows, half of the training
    batch), ``altered`` (an answer altered where it is produced: the
    waveform returned reversed in time, one leaf's update applied twice, the
    largest)."""
    from audio_style_transfer_tpu_torch.parallel import halo
    from audio_style_transfer_tpu_torch.train import trainer as tr
    from audio_style_transfer_tpu_torch.transfer import lbfgs, longform

    saved = (lbfgs.lbfgs_minimize, halo.make_scan_exact_value_and_grad_fn,
             longform._exact_result, tr.Trainer._value_and_grads, tr.scheduled_step)

    if fault == "unchanged":
        def still(fun, x0, *args, **kwargs):
            return saved[0](fun, x0, *args, **kwargs)._replace(x=x0)
        lbfgs.lbfgs_minimize = still
        tr.scheduled_step = lambda opt, lr, step: None
    elif fault == "half":
        def half_window(cfg, spec, t_total, window, t_valid):
            t = t_total // 2
            vg = saved[1](cfg, spec, t, t, t)

            def value_and_grad(params, x, phi_c, phi_s):
                loss, g = vg(params, x[:, :t], phi_c[:t], phi_s)
                return loss, torch.cat([g, torch.zeros_like(g)], dim=1)
            return value_and_grad

        def half_batch(self, params, wav):
            return saved[3](self, params, wav[: wav.shape[0] // 2])
        halo.make_scan_exact_value_and_grad_fn = half_window
        tr.Trainer._value_and_grads = half_batch
    elif fault == "altered":
        def twice(opt, lr, step):
            p = max(opt.param_groups[0]["params"], key=lambda q: q.numel())
            before = p.detach().clone()
            saved[4](opt, lr, step)
            with torch.no_grad():
                p.add_(p - before)
        longform._exact_result = lambda x_np, *a: saved[2](x_np[:, ::-1].copy(), *a)
        tr.scheduled_step = twice
    else:
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield
    finally:
        (lbfgs.lbfgs_minimize, halo.make_scan_exact_value_and_grad_fn,
         longform._exact_result, tr.Trainer._value_and_grads, tr.scheduled_step) = saved


def program(cell, seed: int, seconds: float, device="cuda") -> dict:
    work = cell.kind.Workload(cell, seed, device)
    work.setup()
    work.run_window(seconds)
    units = work.attempted()[0]
    work.free()
    torch.cuda.empty_cache()
    return dict(work.readings(), units=units)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--control-clips", type=int, default=2)
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seconds", type=float, default=0.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    environment()
    torch.set_num_threads(1)
    cell = spec.resolve(spec.load_benchmark(ROOT), args.workload, ROOT)
    ints = lambda s: [int(v) for v in s.split(",") if v]  # noqa: E731
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(dict(rec, workload=cell.name))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for seed in ints(args.seeds):
        emit(dict(program(cell, seed, args.seconds), kind="program", seed=seed))
    for seed in ints(args.control_seeds):
        work = cell.kind.Workload(cell, seed, "cuda")
        if cell.traffic["kind"] == "train_fit":
            work.batches = traffic_gen.tone_batches(seed, cell.traffic)
            emit(dict(control_train(work), kind="control", seed=seed))
        else:
            work.clips = traffic_gen.clip_pairs(seed, cell.traffic)
            emit(dict(control_transfer(work, args.control_clips), kind="control", seed=seed))
        sync("cuda")
        for fault in [f for f in args.faults.split(",") if f]:
            with planted(fault):
                work = cell.kind.Workload(cell, seed, "cuda")
                work.setup()
                work.run_window(args.fault_seconds)
                work.free()
                torch.cuda.empty_cache()
                emit(dict(work.readings(), kind=f"fault:{fault}", seed=seed))
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
