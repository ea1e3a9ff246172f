"""Weights from the seed, made on the device in a few large calls.

TF's uniform_unit_scaling(1.0): each conv weight [F, Cin, Cout] uniform in
+-sqrt(3 / (F Cin)), biases zero, as the program's ``init_params`` draws
them (a different stream of numbers: it draws leaf by leaf on the host). One
``torch.rand`` on the card gives every weight; the leaves are views of it.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.nsynth import layer_shapes


def make_params(cfg: dict, seed: int, device, encoder_only: bool = False):
    """{layer: {"w": [F, Cin, Cout], "b": [Cout]}} float32 on ``device``."""
    shapes = {k: v for k, v in sorted(layer_shapes(cfg).items())
              if not encoder_only or k.startswith("ae_")}
    sizes = [f * cin * cout for f, cin, cout in shapes.values()]
    limits = torch.tensor([math.sqrt(3.0 / (f * cin)) for f, cin, _ in shapes.values()],
                          device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 64))
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    flat.mul_(2.0).sub_(1.0).mul_(
        limits.repeat_interleave(torch.tensor(sizes, device=device), output_size=sum(sizes)))
    biases = torch.zeros(sum(cout for _, _, cout in shapes.values()), device=device)
    params, wo, bo = {}, 0, 0
    for (name, (f, cin, cout)), n in zip(shapes.items(), sizes):
        params[name] = {"w": flat[wo:wo + n].view(f, cin, cout), "b": biases[bo:bo + cout]}
        wo, bo = wo + n, bo + cout
    return params
