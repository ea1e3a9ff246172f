"""Closed-loop exact long-form transfer: one long content clip per request
through ``longform.transfer_exact``, for the mix's epochs at fixed work
(``early_stop_evals=0``): one global gram over the whole clip, as one
window (one trunk pass over the clip), or, where the mix gives
``scan_window``, as a scan over halo-extended windows of that many samples
(the clip trimmed to the 512-sample quantum and padded to whole windows,
the pad masked out of the loss). The style statistics stay averaged over 5
windows of ``style_window`` samples, of the style clip and of the content
clip. Clips start until the window's seconds have passed; the window closes
when the clip in flight ends.

What the configuration gives: the style taps (``style_lyr_ids``, else the
ten of ``stack``, else all ``ae_num_layers``), channel-wise grams or, with
``gatys``, per-layer grams, and the loss's other settings. What the mix
gives: the sizes, the epochs, ``scan_window`` and ``trace_maxiter`` (the
traced clip's L-BFGS iterations; default the configuration's ``maxiter``).

Judged against the float32 reference. Every clip of the window: the loss the
engine reports after the last epoch against the reference's loss at the
returned waveform, relative to the reference's loss at the start (the
problem's scale: the final loss swings by orders of magnitude from seed to
seed, so a gap relative to it swings with it); that the waveform moved from
its start; and that the clip ran all its epochs. Probed clips (one drawn
from the seed among the first ``PROBE_AMONG``, and the window's last): the
content target (the content taps) and the style target (the translated
grams of the style taps) that the evaluation handed to L-BFGS closes over,
over the clip's valid rows, by relative L2 against the reference's targets.
The waveform gradient is not compared: at any waveform that is not
constant bfloat16's rounding alone moves it by 4-9%, and fp8's (the
control's) by 22-38%, under the three times apart that a limit needs; at
the constant start the control read as little as 1.3%.
"""

from __future__ import annotations

import dataclasses
import inspect

import numpy as np
import torch

from portbench import traffic_gen
from portbench.common import clock, model_config, rel_l2, sync
from portbench.reference import nsynth
from portbench.reference.transfer import Loss, statistic_shape
from portbench.spans import EvalSpans
from portbench.weights import make_params

X0 = 1e-6            # the engine's start (methods.py:49-54)
PROBE_AMONG = 3
READINGS = ("loss_gap", "content_target_gap", "style_target_gap", "unmoved_clips",
            "short_clips")


def small(cfg: dict, traffic: dict) -> tuple[dict, dict]:
    """The cell cut to a size the CPU runs in seconds (the harness's tests); a
    scan stays a scan, of three windows."""
    cfg = dict(cfg, cnt_channels=32, nb_channels=32, maxiter=20)
    traffic = dict(traffic, content_samples=9000, style_samples=8192, style_window=4096,
                   distinct=2, epochs=2)
    if "scan_window" in traffic:
        traffic["scan_window"] = 4096
    return cfg, traffic


def geometry(mix: dict) -> tuple[int, int]:
    """(valid rows, optimized rows) of the mix's content clip as
    ``transfer_exact`` trims and pads it: one window trims to the 4096
    quantum; a scan trims to 512 and pads to whole windows."""
    n, window = mix["content_samples"], mix.get("scan_window")
    if window is None or window >= n:
        return n // 4096 * 4096, n // 4096 * 4096
    valid = n // 512 * 512
    return valid, (-(-valid // window) * window if window < valid else valid)


def closure_targets(fun, rows: int, cfg: dict):
    """(content target, style target) among the tensors that an evaluation
    closes over, told apart by their shapes: [.., rows, cnt_channels] and the
    configuration's statistic (``statistic_shape``)."""
    found = {}
    stat = statistic_shape(cfg)
    for v in inspect.getclosurevars(fun).nonlocals.values():
        if not isinstance(v, torch.Tensor):
            continue
        if tuple(v.shape[-2:]) == (rows, cfg["cnt_channels"]):
            found["phi_c"] = v
        elif tuple(v.shape[-3:]) == stat:
            found["target"] = v
    if len(found) != 2:
        raise LookupError(f"the evaluation handed to L-BFGS does not close over both a content "
                          f"and a style target of the expected shapes (found {sorted(found)})")
    return found["phi_c"], found["target"]


class Workload:
    def __init__(self, cell, seed: int, device="cuda"):
        self.cell, self.cfg, self.mix = cell, cell.config, cell.traffic
        self.seed, self.device = seed, torch.device(device)
        self.done = []
        self.spans = EvalSpans(self.device)
        self.probe_at = int(traffic_gen.rng_for(seed, 3).integers(PROBE_AMONG))
        self.rows, self.t_total = geometry(self.mix)
        self.trace_engine = None

    def _engine(self, **changes):
        from audio_style_transfer_tpu_torch.transfer.engine import StyleTransfer, TransferSpec

        c = self.cfg
        style_ids = c.get("style_lyr_ids")
        spec = TransferSpec(stack=c.get("stack"), gatys=c.get("gatys", False),
                            style_lyr_ids=None if style_ids is None else tuple(style_ids),
                            batch_size=self.mix["style_window"],
                            cont_lyr_ids=tuple(c["cont_lyr_ids"]), cnt_channels=c["cnt_channels"],
                            nb_channels=c["nb_channels"], lambd=c["lambd"], gamma=c["gamma"],
                            maxiter=c["maxiter"], early_stop_evals=c["early_stop_evals"],
                            epochs=self.mix["epochs"], compute_dtype=c["compute_dtype"],
                            warm_start=c["warm_start"], write_artifacts=False,
                            device=str(self.device))
        return StyleTransfer(dataclasses.replace(spec, **changes), self.params,
                             model_config(self.cfg))

    def setup(self) -> None:
        self.params = make_params(self.cfg, self.seed, self.device, encoder_only=True)
        self.clips = traffic_gen.clip_pairs(self.seed, self.mix)
        self.engine = self._engine()
        # One clip's targets and one L-BFGS iteration at the cell's shapes.
        self._unit(self._engine(maxiter=1), 0, epochs=1)
        sync(self.device)

    def _unit(self, engine, i: int, epochs: int | None = None) -> dict:
        from audio_style_transfer_tpu_torch.transfer.longform import transfer_exact

        content, style = self.clips[i % len(self.clips)]
        res = transfer_exact(engine, content, style, epochs=epochs or self.mix["epochs"],
                             scan_window=self.mix.get("scan_window"))
        pw = res.per_window
        return {"clip": i % len(self.clips), "x": pw["x"][0], "losses": pw["metrics"],
                "evals": pw["evals"], "epochs_done": int(pw["epochs_done"])}

    def run_window(self, seconds: float) -> None:
        """The window, then the probes (outside it): the targets that each
        probed clip's evaluation, as L-BFGS received it, closes over."""
        from audio_style_transfer_tpu_torch.transfer import lbfgs

        minimize = lbfgs.lbfgs_minimize
        handed = {}

        def receive(fun, *args, **kwargs):
            handed["fun"] = fun
            return minimize(fun, *args, **kwargs)

        lbfgs.lbfgs_minimize = receive
        try:
            sync(self.device)
            t0 = clock()
            while True:
                rec = self._unit(self.engine, len(self.done))
                rec["fun"] = handed.pop("fun", None)
                if self.done and len(self.done) - 1 != self.probe_at:
                    self.done[-1]["fun"] = None  # only the drawn clip's and the latest live on
                self.done.append(rec)
                if clock() - t0 >= seconds:
                    break
            sync(self.device)
            self.window_s = clock() - t0
        finally:
            lbfgs.lbfgs_minimize = minimize
        for r in self.done:
            fun = r.pop("fun")
            if fun is not None:
                phi_c, target = closure_targets(fun, self.t_total, self.cfg)
                r["probe"] = {"phi_c": phi_c[..., :self.rows, :].float().cpu(),
                              "target": target.float().cpu()}

    @property
    def evals(self) -> int:
        return int(sum(int(np.sum(r["evals"])) for r in self.done))

    def end_to_end(self) -> dict:
        return {"transfer_evals_per_s": self.evals / self.window_s}

    def attempted(self) -> tuple[int, int]:
        return len(self.done), sum(r["epochs_done"] < self.mix["epochs"] for r in self.done)

    # -- the traced run -------------------------------------------------------

    def install_spans(self) -> None:
        from audio_style_transfer_tpu_torch.transfer import engine, lbfgs

        self.spans.install(engine, lbfgs)
        maxiter = self.mix.get("trace_maxiter", self.cfg["maxiter"])
        self.trace_engine = (self.engine if maxiter == self.cfg["maxiter"]
                             else self._engine(maxiter=maxiter))

    def span_readings(self) -> dict:
        return self.spans.readings()

    def profile_unit(self) -> int:
        """One more clip's targets and its first epoch (every epoch runs the
        same evaluations), of at most the mix's ``trace_maxiter`` iterations:
        an exact clip's epoch writes some tens of MB of trace, a scan's
        evaluation about 24 MB (its windows' kernels 60 times over)."""
        self.spans.mode = "range"
        rec = self._unit(self.trace_engine, len(self.done), epochs=1)
        sync(self.device)
        return int(np.sum(rec["evals"]))

    def uninstall_spans(self) -> None:
        self.spans.uninstall()

    def trace_context(self) -> dict:
        return {"rows": self.rows, "config": self.cfg, "window_units": self.evals,
                "window_s": self.window_s}

    # -- the check ------------------------------------------------------------

    def free(self) -> None:
        self.engine = self.trace_engine = self.params = None

    def readings(self) -> dict:
        """The numbers compared; a control hands in records of its own in
        ``self.done`` (each with a probe)."""
        params = make_params(self.cfg, self.seed, self.device, encoder_only=True)
        loss = Loss(params, self.cfg)
        out = dict.fromkeys(READINGS, 0.0)
        out["unmoved_clips"] = out["short_clips"] = 0
        x0 = torch.full((self.rows,), X0, device=self.device)
        probed = 0
        with nsynth.float32_exact():
            for r in self.done:
                content, style = self.clips[r["clip"]]
                x_valid = np.asarray(r["x"])[:self.rows]
                x = torch.as_tensor(x_valid, device=self.device)
                with torch.no_grad():
                    phi_c, target = loss.targets(content[:self.rows], style,
                                                 self.mix["style_window"])
                    start = float(loss(x0, phi_c, target)[0])
                    ref = float(loss(x, phi_c, target)[0])
                out["loss_gap"] = max(out["loss_gap"], abs(float(r["losses"][-1]) - ref) / start)
                out["unmoved_clips"] += int(np.all(x_valid == np.float32(X0)))
                out["short_clips"] += int(r["epochs_done"] < self.mix["epochs"]
                                          or min(r["evals"], default=0) < 1)
                p = r.get("probe")
                if p is None:
                    continue
                probed += 1
                for key, got, want in (("content_target_gap", p["phi_c"], phi_c),
                                       ("style_target_gap", p["target"], target)):
                    out[key] = max(out[key], rel_l2(got.reshape(want.shape), want))
        if not probed:
            out.update(content_target_gap=float("inf"), style_target_gap=float("inf"))
        return out

