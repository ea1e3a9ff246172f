"""Full-geometry SciPy L-BFGS-B parity check (counterpart of
audio_style_transfer_tpu/transfer/scipy_parity.py).

The north star holds the port's L-BFGS to final losses within 1% of the
reference's optimizer, SciPy's Fortran L-BFGS-B (reference
methods.py:133-137). This module runs BOTH optimizers on the identical
full-geometry transfer loss (30 layers, width 128, T=16384 by default) and
reports the relative deviation and evaluation counts as one JSON line per
seed.

"Ours" is ``transfer.lbfgs.lbfgs_minimize``, an eager host loop over the
loss and its autograd gradient on the device. SciPy drives a float64
callable that runs the same float32 loss on the device and copies each
gradient to the host. On a CUDA device every evaluation runs the trunk
kernels (K1 and K2, 30 launches each) and the gram kernels (K5 and K6, one
each); the toy geometry (width 8) runs on the CPU only, since the trunk
kernels take width 128 alone.

Run on the card (the default device) or, with the toy geometry at the toy
unit-test length, on the CPU:

    python -m audio_style_transfer_tpu_torch.transfer.scipy_parity \
        --seeds 2 --maxiter 100 --tol 0.01
    python -m audio_style_transfer_tpu_torch.transfer.scipy_parity \
        --toy --device cpu --t 2048 --seeds 1

Exit code 0 iff every seed's |rel| <= tol, or SciPy stalled on an f32
plateau and ours is at most (1 + tol) times SciPy's loss.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _tone(seed: int, t: int) -> np.ndarray:
    """Harmonic test clip (tonal content so the grams carry structure)."""
    r = np.random.RandomState(seed)
    tt = np.arange(t) / 16000.0
    a = sum(
        r.uniform(0.1, 0.4) * np.sin(2 * np.pi * r.uniform(100, 400) * (h + 1) * tt
                                     + r.uniform(0, 6))
        for h in range(4)
    )
    a = 0.8 * a / np.max(np.abs(a)) + 0.05 * r.randn(t)
    return np.clip(a, -1, 1)


def _geometry(toy: bool, stack0: bool = True):
    """(WaveNetAEConfig, LossSpec) of the check: the toy unit-test geometry,
    or the full one with style taps 0..9 (stack 0) or all 30."""
    from audio_style_transfer_tpu_torch.models.wavenet_ae import WaveNetAEConfig
    from audio_style_transfer_tpu_torch.transfer.losses import LossSpec

    if toy:
        cfg = WaveNetAEConfig(
            num_layers=2, num_stages=2, width=8, skip_width=8,
            ae_num_layers=4, ae_num_stages=2, ae_width=8,
            ae_hop_length=64, ae_bottleneck_width=4,
        )
        spec = LossSpec(cont_lyr_ids=(3,), style_layer_ids=(0, 1, 2, 3),
                        cnt_channels=8, nb_channels=8, lambd=10.0, gamma=0.01)
    else:
        cfg = WaveNetAEConfig()
        spec = LossSpec(
            style_layer_ids=tuple(range(10)) if stack0 else tuple(range(30))
        )
    return cfg, spec


def _problem(params, cfg, spec, seed: int, t: int, toy: bool):
    """One seed's problem on the device of ``params``: the clips' targets,
    then (value_and_grad, loss, x0). ``value_and_grad(x)`` returns the
    float32 loss and its autograd gradient for a [1, t] iterate; ``loss(x)``
    the loss alone, without a graph; ``x0`` the reference's 1e-6 start."""
    import torch

    from audio_style_transfer_tpu_torch.signal.mu_law import mu_law_numpy
    from audio_style_transfer_tpu_torch.transfer.losses import (
        transfer_embeds,
        transfer_loss,
    )

    dev = next(iter(params.values()))["w"].device
    if toy:
        rng = np.random.RandomState(seed)
        aud_c = rng.uniform(-0.8, 0.8, t)
        aud_s = rng.uniform(-0.8, 0.8, t)
    else:
        aud_c, aud_s = _tone(2 * seed, t), _tone(2 * seed + 1, t)
    xq_c = torch.tensor(mu_law_numpy(aud_c[None]), dtype=torch.float32, device=dev)
    xq_s = torch.tensor(mu_law_numpy(aud_s[None]), dtype=torch.float32, device=dev)
    with torch.no_grad():
        phi_c, _ = transfer_embeds(params, xq_c, cfg, spec)
        _, phi_s = transfer_embeds(params, xq_s, cfg, spec)

    def value_and_grad(x):
        xv = x.detach().requires_grad_(True)
        v = transfer_loss(params, xv, phi_c, phi_s, cfg, spec)[0]
        (g,) = torch.autograd.grad(v, xv)
        return v.detach(), g

    @torch.no_grad()
    def loss(x):
        return transfer_loss(params, x, phi_c, phi_s, cfg, spec)[0]

    x0 = torch.full((1, t), 1e-6, dtype=torch.float32, device=dev)
    return value_and_grad, loss, x0


def _seed_record(params, cfg, spec, seed: int, t: int, toy: bool, maxiter: int,
                 line_search: str) -> dict:
    """Both optimizers on one seed's problem (``_problem``), from the 1e-6
    start: the record of ``run_parity``."""
    import scipy.optimize

    from audio_style_transfer_tpu_torch.transfer.lbfgs import LBFGSOptions, lbfgs_minimize

    vg, loss, x0 = _problem(params, cfg, spec, seed, t, toy)

    opts = LBFGSOptions(maxiter=maxiter, line_search=line_search)
    res = lbfgs_minimize(vg, x0, opts)
    ours, ours_ev = float(res.f), int(res.n_evals)

    def f_np(x64):
        v, g = vg(x0.new_tensor(np.asarray(x64, np.float32)).reshape(1, t))
        return float(v), g.cpu().numpy().astype(np.float64).reshape(-1)

    sp = scipy.optimize.minimize(
        f_np, np.full(t, 1e-6), jac=True, method="L-BFGS-B",
        options={"maxiter": maxiter},
    )
    scipy_loss = float(sp.fun)
    l0 = float(loss(x0))
    max_g = float(np.max(np.abs(sp.jac)))
    return {
        "seed": seed,
        "t": t,
        "maxiter": maxiter,
        "start_loss": l0,
        "ours": ours,
        "ours_evals": ours_ev,
        "scipy": scipy_loss,
        "scipy_evals": int(sp.nfev),
        "scipy_status": str(sp.message),
        "scipy_max_grad": max_g,
        "rel": (ours - scipy_loss) / abs(scipy_loss),
        "reduction_ours": (l0 - ours) / l0,
        "reduction_scipy": (l0 - scipy_loss) / l0,
        # SciPy's factr test compares f32-rounded losses, so on flat
        # regions it can declare CONVERGENCE far from any stationary
        # point. The signature, detectable from SciPy's run alone, is
        # the factr message with a final gradient an order of magnitude
        # above pgtol (healthy runs end on the projected-gradient
        # criterion, max|g| <= 1e-5).
        "scipy_stalled": bool(
            "REDUCTION OF F" in str(sp.message) and max_g > 1e-4
        ),
    }


def run_parity(t: int = 16384, maxiter: int = 100, seeds: int = 2,
               stack0: bool = True, toy: bool = False,
               line_search: str = "mt", device: str = "cuda") -> list[dict]:
    """Returns one record per seed: {seed, ours, scipy, rel, ...}."""
    from audio_style_transfer_tpu_torch.models.wavenet_ae import init_params

    cfg, spec = _geometry(toy, stack0)
    params = init_params(7 if not toy else 42, cfg, device=device)
    return [_seed_record(params, cfg, spec, seed, t, toy, maxiter, line_search)
            for seed in range(seeds)]


def passes(record: dict, tol: float = 0.01) -> bool:
    """``main``'s rule for one seed: two-sided |rel| <= tol, or, where SciPy
    stalled, ours no more than (1 + tol) times SciPy's loss."""
    if record["scipy_stalled"]:
        return record["ours"] <= record["scipy"] * (1 + tol)
    return abs(record["rel"]) <= tol


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--t", type=int, default=16384)
    p.add_argument("--maxiter", type=int, default=100)
    p.add_argument("--seeds", type=int, default=2)
    p.add_argument("--tol", type=float, default=0.01)
    p.add_argument("--full_stack", action="store_true",
                   help="style grams over all 30 layers instead of stack 0")
    p.add_argument("--toy", action="store_true",
                   help="toy geometry (fast; the unit-test configuration; CPU only)")
    p.add_argument("--line_search", default="mt", choices=("mt", "zoom"),
                   help="mt = SciPy's own dcsrch port; zoom = the engine's "
                        "faster strong-Wolfe zoom (c2=0.5)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the loss and both optimizers' iterates")
    p.add_argument("--device_check", action="store_true",
                   help="print the torch platform and exit 0")
    args = p.parse_args(argv)

    import torch

    if args.device_check:
        print(json.dumps({"platform": "gpu" if torch.cuda.is_available() else "cpu"}))
        return 0

    records = run_parity(t=args.t, maxiter=args.maxiter, seeds=args.seeds,
                         stack0=not args.full_stack, toy=args.toy,
                         line_search=args.line_search, device=args.device)
    ok = True
    for r in records:
        print(json.dumps(r))
        ok = passes(r, args.tol) and ok
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
