"""One encoder residual block per call, with hand-written CUDA kernels
(counterpart of audio_style_transfer_tpu/ops/pallas_encoder.py).

``fused_encoder_block(x, w_dil, b_dil, w_res, b_res, dilation)`` is
``x + relu(conv3_d(relu x) + b_dil) @ w_res[0] + b_res`` (non-causal SAME
padding) on [T, C] or [B, T, C] activations. A batch of clips is flattened
to [B*T, C] and run as one launch whose reads stop at each clip's edge, as
the JAX vmap rule does (pallas_encoder.py:414-454).

The forward is K7f and the waveform backward K7b (csrc/trunk.cu). Unlike the
chained trunk (ops/chain.py) nothing is stashed: K7b recomputes the gate
from x. On CPU tensors each wrapper runs its plain version
(``block_fwd_plain`` / ``block_bwd_plain``, the kernels' cast points); on a
CUDA tensor it launches the kernel or raises. Weight cotangents, when asked
for, come from autograd through ``reference_encoder_block`` (a recompute, as
the JAX custom VJP does).
"""

from __future__ import annotations

import torch

from audio_style_transfer_tpu_torch.ops import _build
from audio_style_transfer_tpu_torch.ops.chain import (
    WIDTH,
    block_out_plain,
    check_cuda,
    check_layer,
    dilated_conv_plain,
    transposed_conv_plain,
)
from audio_style_transfer_tpu_torch.ops.conv import conv1d

_F32 = torch.float32


def block_fwd_plain(x, wd, bd, wr, br, d: int, clip_rows: int):
    """Plain version of K7f: the block output on [rows, C]."""
    return block_out_plain(x, dilated_conv_plain(x, wd, bd, d, clip_rows), wr, br)


def block_bwd_plain(x, g, wd, bd, wr, d: int, clip_rows: int):
    """Plain version of K7b: dx of the block from its input x and output
    cotangent g, with the gate recomputed from x (pallas_encoder.py:337-362)."""
    dt = x.dtype
    y = dilated_conv_plain(x, wd, bd, d, clip_rows)
    dv = g.to(_F32) @ wr.to(_F32).T
    dy = (dv * (y > 0).to(_F32)).to(dt).to(_F32)
    dr = transposed_conv_plain(dy, wd, d, clip_rows)
    return g + (dr * (x > 0).to(_F32)).to(dt)


def _check_weights(wd, bd, wr, br, dt, dev) -> None:
    c = WIDTH
    check_cuda("wd", wd, (3, c, c), dt, dev)
    check_cuda("wr", wr, (c, c), dt, dev)
    check_cuda("bd", bd, (c,), _F32, dev)
    if br is not None:
        check_cuda("br", br, (c,), _F32, dev)


def block_fwd(x, wd, bd, wr, br, d: int, clip_rows: int):
    """One block forward: K7f on CUDA, the plain version on the CPU.

    x [rows, C] (rows = clips * clip_rows), wd [3, C, C], wr [C, C] in x's
    dtype; bd, br [C] float32."""
    if x.device.type == "cpu":
        return block_fwd_plain(x, wd, bd, wr, br, d, clip_rows)
    check_layer(x, clip_rows)
    check_cuda("x", x, x.shape, x.dtype, x.device)
    _check_weights(wd, bd, wr, br, x.dtype, x.device)
    out = torch.empty_like(x)
    status = _build.lib().ast_encoder_fwd(
        x.data_ptr(), wd.data_ptr(), bd.data_ptr(), wr.data_ptr(), br.data_ptr(),
        out.data_ptr(), x.shape[0], clip_rows, d, int(x.dtype == torch.bfloat16),
        _build.stream_ptr(x.device))
    _build.check(status, "ast_encoder_fwd")
    _build.LAUNCHES["K7f"] += 1
    return out


def block_bwd(x, g, wd, bd, wr, d: int, clip_rows: int):
    """One block's dx: K7b on CUDA, the plain version on the CPU."""
    if x.device.type == "cpu":
        return block_bwd_plain(x, g, wd, bd, wr, d, clip_rows)
    check_layer(x, clip_rows)
    check_cuda("x", x, x.shape, x.dtype, x.device)
    check_cuda("g", g, x.shape, x.dtype, x.device)
    _check_weights(wd, bd, wr, None, x.dtype, x.device)
    dy = torch.empty_like(x)
    dx = torch.empty_like(x)
    status = _build.lib().ast_encoder_bwd(
        x.data_ptr(), g.data_ptr(), wd.data_ptr(), bd.data_ptr(), wr.data_ptr(),
        dy.data_ptr(), dx.data_ptr(), x.shape[0], clip_rows, d,
        int(x.dtype == torch.bfloat16), _build.stream_ptr(x.device))
    _build.check(status, "ast_encoder_bwd")
    _build.LAUNCHES["K7b"] += 1
    return dx


def reference_encoder_block(x, w_dil, b_dil, w_res, b_res, dilation: int):
    """Unfused composition of the same block through ops.conv (the JAX
    ``reference_encoder_block``). x is [T, C] or [B, T, C]."""
    xb = x[None] if x.dim() == 2 else x
    y = conv1d(torch.relu(xb), w_dil, b_dil, dilation=dilation, causal=False)
    out = xb + conv1d(torch.relu(y), w_res, b_res)
    return out[0] if x.dim() == 2 else out


def _kernel_weights(x, w_dil, b_dil, w_res, b_res):
    """Weights as the kernels take them: in x's dtype, biases float32."""
    dt = x.dtype
    return (w_dil.to(dt).contiguous(), b_dil.to(_F32).contiguous(),
            w_res[0].to(dt).contiguous(), b_res.to(_F32).contiguous())


class EncoderBlockFunction(torch.autograd.Function):
    """x [B, T, C] -> the block output. Forward through K7f, waveform
    gradient through K7b; weight gradients by recompute through
    ``reference_encoder_block`` only when asked for."""

    @staticmethod
    def forward(ctx, x, w_dil, b_dil, w_res, b_res, dilation):
        b, t, c = x.shape
        wd, bd, wr, br = _kernel_weights(x, w_dil, b_dil, w_res, b_res)
        out = block_fwd(x.reshape(b * t, c).contiguous(), wd, bd, wr, br, dilation, t)
        ctx.save_for_backward(x, w_dil, b_dil, w_res, b_res)
        ctx.dilation = dilation
        return out.view(b, t, c)

    @staticmethod
    def backward(ctx, g):
        x, w_dil, b_dil, w_res, b_res = ctx.saved_tensors
        d = ctx.dilation
        b, t, c = x.shape
        dx = dwd = dbd = dwr = dbr = None
        if ctx.needs_input_grad[0]:
            wd, bd, wr, _ = _kernel_weights(x, w_dil, b_dil, w_res, b_res)
            dx = block_bwd(x.reshape(b * t, c).contiguous(),
                           g.reshape(b * t, c).to(x.dtype).contiguous(),
                           wd, bd, wr, d, t).view(b, t, c)
        if any(ctx.needs_input_grad[1:5]):
            with torch.enable_grad():
                ws = [w.detach().requires_grad_(True) for w in (w_dil, b_dil, w_res, b_res)]
                out = reference_encoder_block(x.detach(), *ws, d)
                dwd, dbd, dwr, dbr = torch.autograd.grad(out, ws, g)
        return dx, dwd, dbd, dwr, dbr, None


def fused_encoder_block(x, w_dil, b_dil, w_res, b_res, dilation: int):
    """Fused residual encoder block on [T, C] or [B, T, C] activations:
    w_dil [3, C, C], b_dil [C], w_res [1, C, C], b_res [C]."""
    d = int(dilation)
    if x.dim() == 2:
        return EncoderBlockFunction.apply(x[None], w_dil, b_dil, w_res, b_res, d)[0]
    return EncoderBlockFunction.apply(x, w_dil, b_dil, w_res, b_res, d)
