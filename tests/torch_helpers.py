"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both frameworks as numpy
arrays. JAX runs on the CPU (tests/conftest.py); Pallas kernels run in
interpret mode, as the JAX package's own tests run them. Torch is capped at
two threads because the suite runs several pytest workers at once.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

# Toy geometry of the slice tests: 4 trunk layers of width 16.
TOY = dict(ae_num_layers=4, ae_width=16)


@pytest.fixture
def interpret_mode(monkeypatch):
    """Run every pallas_call in interpret mode (no TPU here)."""
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    yield


def trunk_inputs(t=512, c=8, n=5, seed=0):
    """x [T, C] and trunk weight stacks wd [n,3,C,C], bd, wr [n,C,C], br."""
    rng = np.random.RandomState(seed)
    x = rng.randn(t, c).astype(np.float32)
    wd = (rng.randn(n, 3, c, c) * 0.2).astype(np.float32)
    bd = (rng.randn(n, c) * 0.1).astype(np.float32)
    wr = (rng.randn(n, c, c) * 0.2).astype(np.float32)
    br = (rng.randn(n, c) * 0.1).astype(np.float32)
    return x, wd, bd, wr, br


def jax_params_np(seed: int = 0, **cfg_kwargs) -> dict:
    """JAX ``init_params(PRNGKey(seed))`` at a config, as numpy arrays."""
    import jax

    from audio_style_transfer_tpu.models.wavenet_ae import WaveNetAEConfig, init_params

    params = init_params(jax.random.PRNGKey(seed), WaveNetAEConfig(**cfg_kwargs))
    return {layer: {k: np.asarray(v) for k, v in e.items()} for layer, e in params.items()}


def torch_params(params_np: dict) -> dict:
    from audio_style_transfer_tpu_torch.ckpt.convert import params_from_numpy

    return params_from_numpy(params_np)


def t(a, dtype=torch.float32) -> torch.Tensor:
    """numpy -> torch tensor on the CPU."""
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def n(x) -> np.ndarray:
    """torch or jax array -> float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(x, np.float32)


class _Parsed(Exception):
    pass


def parser_defaults(main, monkeypatch, *args) -> dict:
    """{dest: default} of every flag of a CLI's argparse parser, read by
    calling ``main(*args)`` with ``parse_args`` replaced so that it stops
    there."""
    import argparse

    seen = {}

    def parse_args(parser, argv=None):
        seen.update({a.dest: a.default for a in parser._actions if a.dest != "help"})
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", parse_args)
        with pytest.raises(_Parsed):
            main(*args)
    return seen

