"""Closed-loop training of the WaveNet autoencoder through ``Trainer.fit``.

The mix gives a pool of distinct batches, made on the host in set-up and
cycled; ``fit`` copies each group of ``steps_per_call`` batches from pinned
memory on its side stream, as users run it. Set-up builds the one trainer
and state from the seed's weights and drives the first full group through
one ``fit`` call, as the window does; a hook on the trainer's per-step
update reads each of the group's first three steps' loss, the optimizer's
state after step 1, and the weights and EMA after step 3. The window goes on
with the same state. Its iterator stops yielding once the window's seconds
have passed, ``fit`` returns with steps still queued, and the window ends at
the synchronise after it.

Judged against the float32 reference, which follows the same three steps
from the same weights: each step's loss, the first gradient as Adam holds it
(exp_avg / (1 - beta1) after step 1), and after step 3 the change of the
weights and of the EMA shadow from the start, each by the worst leaf's gap
of norms. Leaves whose reference gradient is under a thousandth of the
median leaf's (nought but rounding: Adam moves them by round-off alone) are
left out of the changes.
"""

from __future__ import annotations

import itertools
import os
import statistics
import tempfile

import numpy as np
import torch

from portbench import traffic_gen
from portbench.common import clock, model_config, rel_gap, sync, worst_leaf_gap
from portbench.reference import train as ref_train
from portbench.weights import make_params

FIRST_STEPS = 3
TINY_GRAD = 1e-3


def _leaf_norms(tree_or_named) -> dict[str, float]:
    named = (tree_or_named if not any(isinstance(v, dict) for v in tree_or_named.values())
             else ref_train.leaves(tree_or_named))
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in named.items()}


def _change_norms(a: dict, b: dict) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm(a[k].detach().double() - b[k].detach().double()))
            for k in b}


def small(cfg: dict, traffic: dict) -> tuple[dict, dict]:
    """The cell cut to a size the CPU runs in seconds (the harness's tests)."""
    return (dict(cfg, total_batch_size=2, sample_length=1024, steps_per_call=4),
            dict(traffic, batch=2, samples=1024, distinct=4))


class Workload:
    def __init__(self, cell, seed: int, device="cuda"):
        self.cell, self.cfg, self.mix = cell, cell.config, cell.traffic
        self.seed, self.device = seed, torch.device(device)
        self.steps = 0

    def _train_config(self):
        from audio_style_transfer_tpu_torch.train.trainer import TrainConfig

        c = self.cfg
        return TrainConfig(total_batch_size=c["total_batch_size"],
                           sample_length=c["sample_length"], num_iters=c["num_iters"],
                           ema_decay=c["ema_decay"], adam_epsilon=c["adam_epsilon"],
                           logdir=os.path.join(tempfile.gettempdir(), "portbench-train"),
                           save_every_steps=c["save_every_steps"],
                           log_every_steps=c["log_every_steps"], remat=c["remat"],
                           steps_per_call=c["steps_per_call"])

    def _pool(self, stop_at=None):
        """The pool's batches in a cycle, as fit reads them; with ``stop_at``
        (a clock time) it stops once that time has passed."""
        for i in itertools.count(self._next):
            if stop_at is not None and clock() >= stop_at:
                return
            self._next = i + 1
            yield {"wav": self.batches[i % len(self.batches)]}

    def setup(self) -> None:
        from audio_style_transfer_tpu_torch.train.trainer import Trainer

        self.batches = traffic_gen.tone_batches(self.seed, self.mix)
        self._next = 0
        cfg = self._train_config()
        self.trainer = Trainer(cfg, model_config(self.cfg, remat=cfg.remat), device=self.device)
        self.state = self.trainer.init_state(make_params(self.cfg, self.seed, self.device))
        p0 = ref_train.leaves(make_params(self.cfg, self.seed, self.device))
        update = self.trainer._update
        losses, self.first = [], {}

        def judged(state, wav):
            loss = update(state, wav)
            losses.append(loss.detach())
            if len(losses) == 1:
                opt = state["opt_state"]
                beta1 = opt.param_groups[0]["betas"][0]
                self.first["grad1"] = _leaf_norms(
                    {k: opt.state.get(p, {}).get("exp_avg", torch.zeros_like(p)) / (1.0 - beta1)
                     for k, p in ref_train.leaves(state["params"]).items()})
            if len(losses) == FIRST_STEPS:
                self.first["update"] = _change_norms(ref_train.leaves(state["params"]), p0)
                self.first["ema"] = _change_norms(ref_train.leaves(state["ema"]), p0)
            return loss

        self.trainer._update = judged
        try:
            self.trainer.fit(self.state, self._pool(), num_steps=cfg.steps_per_call,
                             log=lambda _: None)
        finally:
            del self.trainer._update
        self.first["losses"] = [float(v) for v in losses[:FIRST_STEPS]]
        self.steps_before = int(self.state["step"])
        sync(self.device)

    def run_window(self, seconds: float) -> None:
        sync(self.device)
        t0 = clock()
        self.trainer.fit(self.state, self._pool(stop_at=t0 + seconds), log=lambda _: None)
        sync(self.device)
        self.window_s = clock() - t0
        self.steps = int(self.state["step"]) - self.steps_before

    def end_to_end(self) -> dict:
        return {"train_step_ms": self.window_s / self.steps * 1e3}

    def attempted(self) -> tuple[int, int]:
        return self.steps, 0

    def install_spans(self) -> None:
        pass

    def span_readings(self) -> dict:
        return {}

    def uninstall_spans(self) -> None:
        pass

    def profile_unit(self) -> int:
        """Half a group of steps through ``fit`` (a partial group, as the
        last of a run; half keeps the trace some tens of MB)."""
        k = max(1, self.cfg["steps_per_call"] // 2)
        self.trainer.fit(self.state, self._pool(), num_steps=k, log=lambda _: None)
        sync(self.device)
        return k

    def trace_context(self) -> dict:
        return {"rows": self.cfg["total_batch_size"] * self.cfg["sample_length"],
                "config": self.cfg, "window_units": self.steps,
                "window_s": self.window_s}

    def free(self) -> None:
        self.trainer = self.state = None

    def readings(self) -> dict:
        params0 = make_params(self.cfg, self.seed, self.device)
        batches = torch.as_tensor(self.batches[:FIRST_STEPS], device=self.device)
        ref = ref_train.follow(params0, batches, self.cfg, steps=FIRST_STEPS)
        p0 = ref_train.leaves(params0)
        return compare(self.first, ref, p0)


def compare(first: dict, ref: dict, p0: dict) -> dict:
    """The numbers compared: a program's (or a control's) readings ``first``
    (losses, norms per leaf) against the reference's run ``ref``."""
    g_ref = _leaf_norms(ref["grad1"])
    median = statistics.median(g_ref.values())
    moved = {k for k, g in g_ref.items() if g >= TINY_GRAD * median}
    losses = list(first.get("losses", ())) + [float("nan")] * FIRST_STEPS
    whole = lambda norms: float(np.sqrt(sum(v * v for v in norms.values())))  # noqa: E731
    return {
        "loss_gap": max(rel_gap(a, b) if np.isfinite(a) else float("inf")
                        for a, b in zip(losses, ref["losses"])),
        "grad_gap": worst_leaf_gap(first["grad1"], g_ref),
        "grad_norm_gap": rel_gap(whole(first["grad1"]), whole(g_ref)),
        "update_gap": worst_leaf_gap(first["update"], _change_norms(ref["params"], p0), moved),
        "ema_gap": worst_leaf_gap(first["ema"], _change_norms(ref["ema"], p0), moved),
    }
