"""How far apart two f32 summation orders put the incremental decoder's
logits, per weight format, on the CPU: the f32 products of the step against
the same products summed in float64 and rounded once.

Run from the repository root:

    python3 -m audio_style_transfer_tpu_torch.tools.probe_int8_order

Geometry of the card tests' generation cases (tests/test_torch_cuda.py): full
width, 10 layers (dilations 1..512), B=2, 1024 steps, seed-0 weights. The
float32 and bfloat16 formats differ by f32 rounding alone. int8 rounds each
product's input x to bf16: where a sum order moves x across a rounding
boundary, x moves by one bf16 ulp (2^-8 of it), which moves later products'
inputs across other boundaries; the spread this prints is the tolerance's
basis for int8 across implementations at this geometry.
"""

from __future__ import annotations

import numpy as np
import torch

from audio_style_transfer_tpu_torch.generate import fastgen
from audio_style_transfer_tpu_torch.models.wavenet_ae import WaveNetAEConfig, init_params


def _f64_products(lin: fastgen._Linear, x: torch.Tensor) -> torch.Tensor:
    """``_Linear.__call__`` with each product summed in float64."""
    if lin.scale is not None:
        y = (x.to(torch.bfloat16).double() @ lin.w.double()).float()
        return (y * lin.scale).add_(lin.b)
    return (x.double() @ lin.w.double()).float() + lin.b


def main() -> int:
    cfg = WaveNetAEConfig(num_layers=10)
    params = init_params(0, cfg)
    gen = np.random.RandomState(0)
    xq = np.floor(gen.uniform(-128, 128, (2, 1024))).astype(np.float32)
    enc = (gen.randn(2, 2, 16) * 0.5).astype(np.float32)
    formats = {
        "float32": params,
        "bfloat16": {k: {m: v.to(torch.bfloat16) for m, v in e.items()}
                     for k, e in params.items()},
        "int8": fastgen.quantize_params_int8(params),
    }
    f32_call = fastgen._Linear.__call__
    for name, p in formats.items():
        ref = fastgen.incremental_logits(p, xq, enc, cfg)
        fastgen._Linear.__call__ = _f64_products
        try:
            alt = fastgen.incremental_logits(p, xq, enc, cfg)
        finally:
            fastgen._Linear.__call__ = f32_call
        d = (alt - ref).abs()
        top = float(ref.abs().max())
        first = float(d[:, :64].max())
        print(f"{name}: max|f64 sums - f32 sums| {float(d.max()):.3e} of max|logit| {top:.3f} "
              f"(rel {float(d.max()) / top:.3e}; first 64 steps {first / top:.3e})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
