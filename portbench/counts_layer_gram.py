"""Bytes and operations of the per-layer (Gatys) gram kernels K8f and K8b
(``audio_style_transfer_tpu_torch/ops/gram.py``, ``csrc/gram.cu``) per
launch, as functions of the shapes, counted as ``counts`` counts the other
kernels: each input read once, each output written once, 2 operations a
multiply-add.
"""

from __future__ import annotations

from portbench.counts import ITEMSIZE, bound_s
from portbench.reference.transfer import style_taps


def k8f(rows: int, c: int, taps: int, dtype: str) -> tuple[float, float]:
    """K8f with its sum of the partial grams: the taps in, the float32 [C, C]
    grams out; one product per pair of channels of each symmetric gram."""
    act = rows * c * ITEMSIZE[dtype]
    return taps * act + taps * c * c * 4, 2.0 * taps * rows * (c * (c + 1) // 2)


def k8b(rows: int, c: int, taps: int, dtype: str) -> tuple[float, float]:
    """K8b: the taps and the grams' float32 gradient in, the taps' cotangents
    out; one [rows, C] x [C, C] product a tap, X (dG + dG^T)."""
    act = rows * c * ITEMSIZE[dtype]
    return 2 * taps * act + taps * c * c * 4, 2.0 * taps * rows * c * c


def layer_gram_eval_bound_s(rows: int, cfg: dict, fwd_launches: int, bwd_launches: int) -> float:
    """The summed bounds of K8f and K8b launches over the configuration's
    style taps at ``rows``."""
    dt, c, taps = cfg["compute_dtype"], cfg["ae_width"], len(style_taps(cfg))
    return (fwd_launches * bound_s(*k8f(rows, c, taps, dt), dt)
            + bwd_launches * bound_s(*k8b(rows, c, taps, dt), dt))
