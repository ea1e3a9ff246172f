"""Host spans of the traced run, from wrappers around the program's calls
into L-BFGS.

``EvalSpans.install`` replaces ``lbfgs_minimize`` where the program looks it
up (a module attribute) by a wrapper that times the whole call and each call
of the ``value_and_grad`` it is given. In ``"time"`` mode each evaluation
ends with a synchronise, so its span holds its device work; in ``"range"``
mode it only opens ``torch.profiler`` ranges, ``portbench.lbfgs`` around the
call and ``portbench.eval`` around each evaluation, so that a capture can
tell the optimizer's and the evaluations' kernels from the rest.
"""

from __future__ import annotations

import functools

import torch

from portbench.common import clock, sync

EVAL_RANGE = "portbench.eval"
LBFGS_RANGE = "portbench.lbfgs"


class EvalSpans:
    def __init__(self, device):
        self.device = device
        self.mode = "time"
        self.lbfgs_s = 0.0
        self.eval_s = 0.0
        self.evals = 0
        self._saved = []

    def _wrap(self, minimize):
        @functools.wraps(minimize)
        def lbfgs_minimize(fun, x0, *args, **kwargs):
            def value_and_grad(x):
                if self.mode == "range":
                    with torch.profiler.record_function(EVAL_RANGE):
                        return fun(x)
                t0 = clock()
                out = fun(x)
                sync(self.device)
                self.eval_s += clock() - t0
                self.evals += 1
                return out

            if self.mode == "range":
                with torch.profiler.record_function(LBFGS_RANGE):
                    return minimize(value_and_grad, x0, *args, **kwargs)
            t0 = clock()
            res = minimize(value_and_grad, x0, *args, **kwargs)
            sync(self.device)
            self.lbfgs_s += clock() - t0
            return res

        return lbfgs_minimize

    def install(self, *modules) -> None:
        for m in modules:
            if hasattr(m, "lbfgs_minimize"):
                self._saved.append((m, m.lbfgs_minimize))
                m.lbfgs_minimize = self._wrap(m.lbfgs_minimize)

    def uninstall(self) -> None:
        for m, fn in reversed(self._saved):
            m.lbfgs_minimize = fn
        self._saved.clear()

    def readings(self) -> dict:
        """Per evaluation: the wall of the call, and L-BFGS's own time (the
        calls' time outside their evaluations), in ms."""
        if not self.evals:
            return {}
        return {"eval_ms": self.eval_s / self.evals * 1e3,
                "lbfgs_host_ms": (self.lbfgs_s - self.eval_s) / self.evals * 1e3}
