"""Tensor-parallel WaveNet decoder: the width axis sharded over the ranks of a
mesh axis (counterpart of audio_style_transfer_tpu/parallel/tensor.py).

Megatron-style, as the JAX module lays it out:
  * the gated dilated conv (width -> 2 * width) is column-parallel: each rank
    holds 2 * width / n output channels, re-ordered so that a rank owns
    matching (sigmoid, tanh) pairs and the gate needs no communication;
  * the conditioning projection ``cond_map_i`` is sharded the same way, so
    ``condition`` stays local;
  * the residual and skip 1x1 projections are fused into one row-parallel
    product (its input axis is the gated width, already sharded) whose
    partial products meet in one all-reduce per layer, the bias added after
    it;
  * the thin rest (startconv, skip_start, out1, logits) is replicated.

JAX's ``shard_map`` runs one program over all devices and transposes the
collectives itself. Here every rank runs its own program, so the autograd
pair is explicit (``parallel.mesh``): ``copy_to_ranks`` (identity forward,
all-reduce backward) where the replicated ``l`` (and ``encoding``, when it
takes a gradient) enters the sharded convs, and ``psum`` (all-reduce
forward, identity backward) on the row-parallel output. Each rank takes its
shard of the re-laid-out weights through ``take_shard``, whose backward
all-gathers the shards, so ``torch.autograd.grad`` lands the whole gradient
of the ORIGINAL parameters on every rank, as ``jax.grad`` does.

The decoder's ops are ``ops.conv`` (``conv1d``, ``shift_right``,
``condition``) with ``models.wavenet_ae.decode_logits``'s cast points; like
the single-device decoder it runs no hand-written kernel.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.utils.checkpoint

from audio_style_transfer_tpu_torch.models.wavenet_ae import Params, WaveNetAEConfig
from audio_style_transfer_tpu_torch.ops.conv import condition, conv1d, shift_right
from audio_style_transfer_tpu_torch.parallel.mesh import copy_to_ranks, psum, take_shard


def _interleave_gate_halves(w, b, width: int, n: int):
    """Reorder [..., 2 * width] outputs so that a contiguous 1/n chunk holds
    the (sigmoid, tanh) pair of its width / n channels."""
    m = width // n
    sig, tnh = w[..., :width], w[..., width:]
    w2 = torch.cat([t for k in range(n)
                    for t in (sig[..., k * m:(k + 1) * m], tnh[..., k * m:(k + 1) * m])], dim=-1)
    bs, bt = b[:width], b[width:]
    b2 = torch.cat([t for k in range(n) for t in (bs[k * m:(k + 1) * m], bt[k * m:(k + 1) * m])])
    return w2, b2


def tp_prepare_decoder_params(params: Params, n: int, cfg: WaveNetAEConfig) -> Params:
    """Decoder params re-laid-out for n-way tensor parallelism: the gate and
    cond_map outputs interleaved by shard, res_i and skip_i fused into
    res_skip_i. Differentiable (slices and concatenations only), so a
    gradient through it lands on the ORIGINAL parameters."""
    gate_names = {name for i in range(1, cfg.num_layers + 1)
                  for name in (f"dilatedconv_{i}", f"cond_map_{i}")}
    fused_away = {name for i in range(1, cfg.num_layers + 1)
                  for name in (f"res_{i}", f"skip_{i}")}
    out: Params = {}
    for name, entry in params.items():
        if name in gate_names:
            w, b = _interleave_gate_halves(entry["w"], entry["b"], cfg.width, n)
            out[name] = {"w": w, "b": b}
        elif name not in fused_away:
            out[name] = entry
    for i in range(1, cfg.num_layers + 1):
        res, skip = params[f"res_{i}"], params[f"skip_{i}"]
        out[f"res_skip_{i}"] = {"w": torch.cat([res["w"], skip["w"]], dim=-1),
                                "b": torch.cat([res["b"], skip["b"]])}
    return out


def _tp_param_specs(prepared: Params) -> dict:
    """The axis along which each prepared tensor is sharded, None where it
    is replicated (JAX's PartitionSpecs): the gate and cond_map convs by
    output channel, the fused res+skip by input channel with its bias
    replicated (added once, after the all-reduce), everything else
    replicated."""
    specs = {}
    for name, entry in prepared.items():
        if name.startswith(("dilatedconv_", "cond_map_")) and not name.endswith("out1"):
            specs[name] = {"w": 2, "b": 0}
        elif name.startswith("res_skip_"):
            specs[name] = {"w": 1, "b": None}
        else:
            specs[name] = {k: None for k in entry}
    return specs


def tp_decode_logits(params: Params, x_quantized: torch.Tensor, encoding: torch.Tensor,
                     cfg: WaveNetAEConfig, mesh, axis_name: str = "model") -> torch.Tensor:
    """Teacher-forced decoder logits [batch, time, 256] with the width axis
    sharded over ``mesh[axis_name]``: ``models.decode_logits``'s values (to
    float32 summation order) on every rank. Takes the ORIGINAL params and
    the whole inputs on every rank; the re-layout and the shards are taken
    inside, differentiably. Every rank of the axis must call it together.
    With ``cfg.remat`` and grad mode on each block runs under
    ``torch.utils.checkpoint``; its recompute repeats the block's all-reduce,
    in the same order on every rank."""
    group = mesh.get_group(axis_name)
    n = dist.get_world_size(group)
    if cfg.width % n:
        raise ValueError(f"decoder width {cfg.width} does not split over the {n} ranks of "
                         f"{axis_name!r}")
    dtype = cfg.compute_dtype
    prepared = tp_prepare_decoder_params(params, n, cfg)
    p = {name: {k: v.to(dtype) if dims[k] is None else take_shard(v.to(dtype), dims[k], group)
                for k, v in prepared[name].items()}
         for name, dims in _tp_param_specs(prepared).items()}

    x_scaled = (x_quantized.to(torch.float32) / 128.0).to(dtype)[..., None]
    encoding = encoding.to(dtype)
    enc_needs_grad = encoding.requires_grad

    def block(l, s, p_dil, p_cond, p_rs, encoding, i):
        enc = copy_to_ranks(encoding, group) if enc_needs_grad else encoding
        d = conv1d(copy_to_ranks(l, group), p_dil["w"], p_dil["b"],
                   dilation=cfg.dilation(i - 1), causal=True)
        d = condition(d, conv1d(enc, p_cond["w"], p_cond["b"]))
        m = d.shape[2] // 2
        d = torch.sigmoid(d[:, :, :m]) * torch.tanh(d[:, :, m:])
        rs = psum(conv1d(d, p_rs["w"]), group) + p_rs["b"].to(d.dtype)
        return l + rs[:, :, :cfg.width], s + rs[:, :, cfg.width:]

    l = conv1d(shift_right(x_scaled), p["startconv"]["w"], p["startconv"]["b"], causal=True)
    s = conv1d(l, p["skip_start"]["w"], p["skip_start"]["b"])
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(1, cfg.num_layers + 1):
        args = (l, s, p[f"dilatedconv_{i}"], p[f"cond_map_{i}"], p[f"res_skip_{i}"], encoding, i)
        if remat:
            l, s = torch.utils.checkpoint.checkpoint(block, *args, use_reentrant=False)
        else:
            l, s = block(*args)
    s = torch.relu(s)
    s = condition(conv1d(s, p["out1"]["w"], p["out1"]["b"]),
                  conv1d(encoding, p["cond_map_out1"]["w"], p["cond_map_out1"]["b"]))
    s = torch.relu(s)
    return conv1d(s, p["logits"]["w"], p["logits"]["b"]).to(torch.float32)
