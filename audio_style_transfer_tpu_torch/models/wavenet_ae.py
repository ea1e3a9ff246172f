"""NSynth WaveNet autoencoder: encoder taps, the teacher-forced decoder, the
mu-law NLL and the full forward pass (counterpart of
audio_style_transfer_tpu/models/wavenet_ae.py).

Parameters are a plain dict ``{layer: {"w": [F, Cin, Cout], "b": [Cout]}}``
with the TF scope names of the JAX package, so weights cross over unchanged
(ckpt/convert.py). ``extracts`` holds
  [0..29]  the 30 encoder residual-trunk states,
  [30]     ``enc_``, an alias of extracts[29],
  [31]     the bottleneck conv output before hop pooling.

``decode_logits`` runs the causal dilated convs of ``ops.conv.conv1d`` (the
JAX package leaves the decoder to XLA); on CUDA tensors each block's
elementwise epilogues (biases, conditioning, gate, residual and skip adds)
are the fused kernels of ``ops.decoder``, on CPU tensors plain torch. It is
the oracle of the incremental decoder in generate/fastgen.py and the decoder
of training. With
``cfg.remat`` each decoder block runs under ``torch.utils.checkpoint``, so a
backward keeps only each block's inputs ``(l, s)`` and recomputes the gated
[B, T, 2 * width] internals (JAX: ``jax.checkpoint``). The encoder needs no
remat in the chained flavour: the trunk keeps one mask byte per element and
layer for its backward, never an activation (``ops.chain.TrunkFunction``).

The encoder trunk runs in one of two flavours, hand-written kernels on CUDA tensors
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
import torch.utils.checkpoint

from audio_style_transfer_tpu_torch.ops.chain import (
    fused_trunk,
    stack_trunk_weights,
    window_rows,
)
from audio_style_transfer_tpu_torch.ops.conv import condition, conv1d, pool1d, shift_right
from audio_style_transfer_tpu_torch.ops.decoder import decoder_gate, decoder_residual
from audio_style_transfer_tpu_torch.ops.encoder import fused_encoder_block
from audio_style_transfer_tpu_torch.signal.mu_law import mu_law

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
    # Recompute each decoder block on the backward pass (see the module
    # docstring). Off by default: transfer and generation build no decoder
    # backward; the trainer turns it on (TrainConfig.remat).
    remat: bool = False

    # Piecewise-constant learning rate by step (reference model.py:13-21).
    learning_rate_schedule = {
        0: 2e-4,
        90000: 4e-4 / 3,
        120000: 6e-5,
        150000: 4e-5,
        180000: 2e-5,
        210000: 6e-6,
        240000: 2e-6,
    }

    def dilation(self, layer: int) -> int:
        """Decoder dilation pattern (reference model.py:149)."""
        return 2 ** (layer % self.num_stages)

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


def init_params(seed: int | torch.Generator = 0, cfg: WaveNetAEConfig | None = None,
                device: torch.device | str = "cpu") -> Params:
    """TF uniform_unit_scaling(1.0) weights, U(+-sqrt(3 / (F * Cin))), and
    zero biases, drawn on the CPU from ``seed``: a ``torch.Generator`` (its
    state advances), or an int that seeds a new one. The JAX keys are not
    reproduced bit for bit."""
    cfg = cfg or WaveNetAEConfig()
    gen = seed if isinstance(seed, torch.Generator) else torch.Generator().manual_seed(int(seed))
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
    masked in plain torch, the layers by the windowed chained trunk (K1/K2)
    or, in the per-layer flavour, by the windowed blocks (K7f/K7b: JAX runs
    that flavour as masked XLA convs, ``masked(enc + d)``, with the same
    result). Batch 1 only. The JAX ``valid_mask`` (arbitrary masks) belongs to
    the mesh path and is not ported.
    """
    cfg = cfg or WaveNetAEConfig()
    dtype = cfg.compute_dtype
    x_scaled = (x_quantized.to(torch.float32) / 128.0).to(dtype)[..., None]
    enc = _apply(params, "ae_startconv", x_scaled, causal=False, dtype=dtype)
    if valid_window is not None:
        if enc.shape[0] != 1:
            raise ValueError(
                f"encoder_trunk: a valid window is one clip's state, got batch {enc.shape[0]}")
        t = enc.shape[1]
        enc = enc * window_rows(valid_window, t, t, enc.device).to(dtype)[None]

    n = cfg.ae_num_layers
    if cfg.fused_encoder and not cfg.chain_encoder:
        extracts = []
        for k in range(1, n + 1):
            pd, pr = params[f"ae_dilatedconv_{k}"], params[f"ae_res_{k}"]
            enc = fused_encoder_block(enc, pd["w"].to(dtype), pd["b"].to(dtype),
                                      pr["w"].to(dtype), pr["b"].to(dtype),
                                      cfg.ae_dilation(k - 1), valid_window)
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


def encoder_features(params: Params, x_quantized: torch.Tensor,
                     cfg: WaveNetAEConfig | None = None) -> dict:
    """Encoder pass as one dict: every tap (``extracts``), the ``encoding``,
    and ``before_enc``, the last block's output before the bottleneck."""
    extracts, encoding = encoder_extracts(params, x_quantized, cfg)
    return {"extracts": extracts, "encoding": encoding, "before_enc": extracts[-2]}


def _plain_decoder_block(cfg: WaveNetAEConfig, i: int, l, s, p_dil, p_cond, p_res, p_skip,
                         encoding):
    """Decoder block i in plain torch, the block of CPU tensors."""
    dtype = cfg.compute_dtype

    def apply(p, x, dilation=1):
        return conv1d(x, p["w"].to(dtype), p["b"].to(dtype), dilation=dilation, causal=True)

    d = apply(p_dil, l, dilation=cfg.dilation(i - 1))
    d = condition(d, apply(p_cond, encoding))
    m = d.shape[2] // 2
    d = torch.sigmoid(d[:, :, :m]) * torch.tanh(d[:, :, m:])
    return l + apply(p_res, d), s + apply(p_skip, d)


def _fused_decoder_block(cfg: WaveNetAEConfig, i: int, l, s, p_dil, p_cond, p_res, p_skip,
                         encoding):
    """Decoder block i with its elementwise epilogues fused (ops/decoder.py):
    the same four products, without their biases, which the gate and the
    residual add. The same values as the plain block, bit for bit in the
    forward."""
    dtype = cfg.compute_dtype

    def w(p):
        return p["w"].to(dtype)

    def b(p):
        return p["b"].to(dtype)

    y = conv1d(l, w(p_dil), dilation=cfg.dilation(i - 1), causal=True)
    gated = decoder_gate(y, conv1d(encoding, w(p_cond)), b(p_dil), b(p_cond))
    return decoder_residual(l, s, conv1d(gated, w(p_res)), conv1d(gated, w(p_skip)), b(p_res),
                            b(p_skip))


def _decoder_block(cfg: WaveNetAEConfig, i: int, l, s, p_dil, p_cond, p_res, p_skip,
                   encoding):
    """Decoder block i (1-based, reference model.py:148-177): (l, s) -> (l, s).
    CUDA tensors take the fused kernels, CPU tensors the plain block."""
    block = _fused_decoder_block if l.is_cuda else _plain_decoder_block
    return block(cfg, i, l, s, p_dil, p_cond, p_res, p_skip, encoding)


def decode_logits(params: Params, x_quantized: torch.Tensor, encoding: torch.Tensor,
                  cfg: WaveNetAEConfig | None = None) -> torch.Tensor:
    """Teacher-forced WaveNet decoder (reference model.py:136-187): logits
    [batch, time, 256] of x_quantized [batch, time] (mu-law quantized space)
    conditioned on encoding [batch, time / hop, bottleneck]. Weights of
    another dtype than ``cfg.compute_dtype`` (bfloat16 ones) are cast to it,
    as the JAX ``_apply`` does. With ``cfg.remat`` and grad mode on, each
    block runs under ``torch.utils.checkpoint``: the same values, less memory
    kept for the backward."""
    cfg = cfg or WaveNetAEConfig()
    dtype = cfg.compute_dtype
    x_scaled = (x_quantized.to(torch.float32) / 128.0).to(dtype)[..., None]
    if x_scaled.shape[1] % encoding.shape[1]:
        raise ValueError(f"decode_logits: time {x_scaled.shape[1]} is no multiple of "
                         f"{encoding.shape[1]} encoding frames")
    encoding = encoding.to(dtype)

    def apply(name, x, dilation=1):
        return _apply(params, name, x, dilation=dilation, causal=True, dtype=dtype)

    l = apply("startconv", shift_right(x_scaled))
    s = apply("skip_start", l)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(1, cfg.num_layers + 1):
        args = (cfg, i, l, s, params[f"dilatedconv_{i}"], params[f"cond_map_{i}"],
                params[f"res_{i}"], params[f"skip_{i}"], encoding)
        if remat:
            l, s = torch.utils.checkpoint.checkpoint(_decoder_block, *args, use_reentrant=False)
        else:
            l, s = _decoder_block(*args)
    s = torch.relu(s)
    s = condition(apply("out1", s), apply("cond_map_out1", encoding))
    s = torch.relu(s)
    return apply("logits", s).to(torch.float32)


def nll_loss(logits: torch.Tensor, x_quantized: torch.Tensor) -> torch.Tensor:
    """Mu-law softmax NLL (reference model.py:186-194): the mean over rows of
    -log softmax(logits)[label], label = int(x_quantized) + 128, truncated
    toward zero as JAX's ``astype`` truncates.

    Out-of-range labels behave as JAX's ``take_along_axis`` makes them: a
    label in [-Q, 0) counts from the end (Q = logits.shape[-1]); a label
    >= Q or < -Q gives its row NaN, so the mean is NaN, and contributes no
    gradient. ``x_quantized = mu_law(+1.0) = 128`` is such a label (256):
    the reference's behaviour, kept (ROADMAP.md, faults, item 5). Nothing
    is asserted on the device, so a CUDA context survives it."""
    q = logits.shape[-1]
    labels = x_quantized.to(torch.int32).reshape(-1).to(torch.int64) + 128
    logp = torch.log_softmax(logits.reshape(-1, q), dim=-1)
    idx = torch.where(labels < 0, labels + q, labels)
    inside = (idx >= 0) & (idx < q)
    picked = logp.gather(1, idx.clamp(0, q - 1)[:, None])[:, 0]
    picked = torch.where(inside, picked, torch.full_like(picked, float("nan")))
    return -picked.mean()


def forward(params: Params, inputs: dict, cfg: WaveNetAEConfig | None = None,
            is_training: bool = True) -> dict:
    """Full AE forward pass mirroring reference ``cfg.build`` (model.py:57-205),
    with the keys of the JAX ``forward``.

    ``inputs`` holds either 'quantized_wav' (already mu-law'd values, the
    transfer fork's input) or 'wav' (raw audio, encoded with the continuous
    mu-law, reference nsynth/wavenet/model.py:213). The dict keeps every tap
    and the softmax over every row alive as long as it lives; training takes
    the loss alone (train/trainer.py::train_loss)."""
    del is_training
    cfg = cfg or WaveNetAEConfig()
    x_quantized = inputs["quantized_wav"] if "quantized_wav" in inputs else mu_law(inputs["wav"])
    extracts, encoding = encoder_extracts(params, x_quantized, cfg)
    logits = decode_logits(params, x_quantized, encoding, cfg)
    loss = nll_loss(logits, x_quantized)
    return {
        "predictions": torch.softmax(logits.reshape(-1, cfg.quant_channels), dim=-1),
        "loss": loss,
        "eval": {"nll": loss},
        "quantized_input": x_quantized,
        "encoding": encoding,
        "before_enc": extracts[-2],
        "extracts": extracts,
    }
