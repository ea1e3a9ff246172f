"""Precision of a reference pass.

``Exact`` leaves every value as it is (float32). ``Fp8`` rounds the values at
the points where a low-precision program rounds them (each conv's input,
weight and output) to float8 with one scale per tensor: e4m3 in the forward,
e5m2 for the cotangents of the backward, as fp8 training rounds them. It is
the precision one step below the configurations' bfloat16, the controls'.
"""

from __future__ import annotations

import torch

_E4M3 = torch.float8_e4m3fn
_E5M2 = torch.float8_e5m2


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    if not torch.isfinite(amax) or amax == 0:
        return x
    scale = torch.finfo(dtype).max / amax
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Fp8Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, _E4M3)

    @staticmethod
    def backward(ctx, g):
        return _round(g, _E5M2)


class Exact:
    name = "float32"

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x


class Fp8:
    name = "fp8"

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _Fp8Round.apply(x)


EXACT = Exact()
FP8 = Fp8()
