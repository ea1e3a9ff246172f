"""NSynth WaveNet autoencoder, encoder taps (counterpart of
audio_style_transfer_tpu/models/wavenet_ae.py; the decoder is not ported yet).

Parameters are a plain dict ``{layer: {"w": [F, Cin, Cout], "b": [Cout]}}``
with the TF scope names of the JAX package, so weights cross over unchanged
(ckpt/convert.py). ``extracts`` holds
  [0..29]  the 30 encoder residual-trunk states,
  [30]     ``enc_``, an alias of extracts[29],
  [31]     the bottleneck conv output before hop pooling.

The trunk runs in one of two flavours, hand-written kernels on CUDA tensors
and their plain torch versions on CPU tensors either way:
  - the chained trunk, ``ops.chain.fused_trunk`` (K1/K2): every config but
    the next one;
  - per-layer blocks, ``ops.encoder.fused_encoder_block`` (K7f/K7b), when
    ``fused_encoder and not chain_encoder``, as the JAX
    ``TransferSpec(fused_encoder=True, chain_encoder=False)`` selects.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from audio_style_transfer_tpu_torch.ops.chain import (
    fused_trunk,
    stack_trunk_weights,
    window_rows,
)
from audio_style_transfer_tpu_torch.ops.conv import conv1d, pool1d
from audio_style_transfer_tpu_torch.ops.encoder import fused_encoder_block

Params = dict[str, dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class WaveNetAEConfig:
    """Geometry of the NSynth WaveNet AE (reference model.py:69-77,22-23)."""

    num_layers: int = 30
    num_stages: int = 10
    filter_length: int = 3
    width: int = 512
    skip_width: int = 256
    ae_num_layers: int = 30
    ae_num_stages: int = 10
    ae_filter_length: int = 3
    ae_width: int = 128
    ae_hop_length: int = 512
    ae_bottleneck_width: int = 16
    quant_channels: int = 256
    compute_dtype: Any = torch.float32
    # Trunk flavour (the JAX config's flags): per-layer blocks iff
    # fused_encoder and not chain_encoder, else the chained trunk.
    fused_encoder: bool = False
    chain_encoder: bool = False

    def ae_dilation(self, layer: int) -> int:
        """Encoder dilation pattern (reference model.py:98)."""
        return 2 ** (layer % self.ae_num_stages)


def _conv_shapes(cfg: WaveNetAEConfig) -> dict[str, tuple[int, int, int]]:
    """Layer name -> (filter, in, out), mirroring reference model.py:88-186."""
    shapes: dict[str, tuple[int, int, int]] = {}
    shapes["ae_startconv"] = (cfg.ae_filter_length, 1, cfg.ae_width)
    for k in range(1, cfg.ae_num_layers + 1):
        shapes[f"ae_dilatedconv_{k}"] = (cfg.ae_filter_length, cfg.ae_width, cfg.ae_width)
        shapes[f"ae_res_{k}"] = (1, cfg.ae_width, cfg.ae_width)
    shapes["ae_bottleneck"] = (1, cfg.ae_width, cfg.ae_bottleneck_width)

    shapes["startconv"] = (cfg.filter_length, 1, cfg.width)
    shapes["skip_start"] = (1, cfg.width, cfg.skip_width)
    for i in range(1, cfg.num_layers + 1):
        shapes[f"dilatedconv_{i}"] = (cfg.filter_length, cfg.width, 2 * cfg.width)
        shapes[f"cond_map_{i}"] = (1, cfg.ae_bottleneck_width, 2 * cfg.width)
        shapes[f"res_{i}"] = (1, cfg.width, cfg.width)
        shapes[f"skip_{i}"] = (1, cfg.width, cfg.skip_width)
    shapes["out1"] = (1, cfg.skip_width, cfg.skip_width)
    shapes["cond_map_out1"] = (1, cfg.ae_bottleneck_width, cfg.skip_width)
    shapes["logits"] = (1, cfg.skip_width, cfg.quant_channels)
    return shapes


def init_params(seed: int = 0, cfg: WaveNetAEConfig | None = None,
                device: torch.device | str = "cpu") -> Params:
    """TF uniform_unit_scaling(1.0) weights, U(+-sqrt(3 / (F * Cin))), and
    zero biases, drawn from a ``torch.Generator`` seeded with ``seed`` (the
    JAX keys are not reproduced bit for bit)."""
    cfg = cfg or WaveNetAEConfig()
    gen = torch.Generator().manual_seed(int(seed))
    params: Params = {}
    for name, (f, cin, cout) in sorted(_conv_shapes(cfg).items()):
        limit = float(np.sqrt(3.0 / (f * cin)))
        w = (torch.rand((f, cin, cout), generator=gen, dtype=torch.float32) * 2.0 - 1.0) * limit
        params[name] = {
            "w": w.to(device),
            "b": torch.zeros((cout,), dtype=torch.float32, device=device),
        }
    return params


def _apply(params: Params, name: str, x, *, dilation=1, causal=True, dtype=None):
    w, b = params[name]["w"], params[name]["b"]
    if dtype is not None and w.dtype != dtype:
        w, b = w.to(dtype), b.to(dtype)
    return conv1d(x, w, b, dilation=dilation, causal=causal)


def encoder_trunk(params: Params, x_quantized: torch.Tensor,
                  cfg: WaveNetAEConfig | None = None, needed_taps=None, valid_window=None):
    """The 32-entry ``extracts`` list without hop pooling (any time length).

    ``needed_taps``: trunk-layer ids (0..29) the caller consumes; with the
    chained trunk the other trunk entries are None (None asks for every
    tap). The per-layer flavour returns every tap. Ids 30 and 31 derive from
    tap 29, which is always kept.

    ``valid_window``: (lo, hi) Python ints marking the positions that lie
    inside the global sequence (the halo windows of parallel/halo.py).
    Positions outside are re-zeroed after the start conv and after every
    trunk layer, so each conv sees the zeros that SAME padding at the global
    clip edge would have given it (a zero input alone is not enough: the
    biases make activations over padding nonzero). The start conv's output is
    masked in plain torch, the layers by the windowed chained trunk (K1/K2).
    Batch 1 only; the per-layer flavour (K7f/K7b) has no windowed form, in
    the JAX package either, and raises. The JAX ``valid_mask`` (arbitrary
    masks) belongs to the mesh path and is not ported.
    """
    cfg = cfg or WaveNetAEConfig()
    dtype = cfg.compute_dtype
    x_scaled = (x_quantized.to(torch.float32) / 128.0).to(dtype)[..., None]
    enc = _apply(params, "ae_startconv", x_scaled, causal=False, dtype=dtype)
    if valid_window is not None:
        if enc.shape[0] != 1:
            raise ValueError(
                f"encoder_trunk: a valid window is one clip's state, got batch {enc.shape[0]}")
        if cfg.fused_encoder and not cfg.chain_encoder:
            raise NotImplementedError(
                "encoder_trunk: the per-layer flavour (fused_encoder=True, "
                "chain_encoder=False) has no valid-window form; use the chained trunk")
        t = enc.shape[1]
        enc = enc * window_rows(valid_window, t, t, enc.device).to(dtype)[None]

    n = cfg.ae_num_layers
    if cfg.fused_encoder and not cfg.chain_encoder:
        extracts = []
        for k in range(1, n + 1):
            pd, pr = params[f"ae_dilatedconv_{k}"], params[f"ae_res_{k}"]
            enc = fused_encoder_block(enc, pd["w"].to(dtype), pd["b"].to(dtype),
                                      pr["w"].to(dtype), pr["b"].to(dtype),
                                      cfg.ae_dilation(k - 1))
            extracts.append(enc)
        extracts.append(enc)  # enc_ duplicate tap (reference model.py:118-119)
        extracts.append(_apply(params, "ae_bottleneck", enc, dtype=dtype))
        return extracts

    dils = tuple(cfg.ae_dilation(k) for k in range(n))
    needed = (set(range(n)) if needed_taps is None
              else {min(int(i), n - 1) for i in needed_taps})
    emit = tuple(sorted(needed | {n - 1}))
    wd, bd, wr, br = (a.to(dtype) for a in stack_trunk_weights(params, n))
    tap_map = dict(zip(emit, fused_trunk(enc, wd, bd, wr, br, dils, emit,
                                         valid_window=valid_window)))
    extracts = [tap_map.get(k) for k in range(n)]
    extracts.append(extracts[-1])  # enc_ duplicate tap (reference model.py:118-119)
    extracts.append(_apply(params, "ae_bottleneck", extracts[-1], dtype=dtype))
    return extracts


def receptive_field_radius(cfg: WaveNetAEConfig | None = None) -> int:
    """One-sided receptive field of the encoder trunk in samples: 1 for the
    start conv plus each layer's dilation (filter 3, symmetric); 3070 at the
    full geometry."""
    cfg = cfg or WaveNetAEConfig()
    half = (cfg.ae_filter_length - 1) // 2
    return half + sum(cfg.ae_dilation(k) * half for k in range(cfg.ae_num_layers))


def encoder_extracts(params: Params, x_quantized: torch.Tensor,
                     cfg: WaveNetAEConfig | None = None, needed_taps=None):
    """(extracts, encoding) of a [batch, time] mu-law quantized input; the
    encoding is the hop-pooled bottleneck [batch, time / hop, bottleneck]."""
    cfg = cfg or WaveNetAEConfig()
    extracts = encoder_trunk(params, x_quantized, cfg, needed_taps=needed_taps)
    encoding = pool1d(extracts[-1], cfg.ae_hop_length, mode="avg")
    return extracts, encoding
