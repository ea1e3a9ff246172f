"""One encoder residual block per call, with hand-written CUDA kernels
(counterpart of audio_style_transfer_tpu/ops/pallas_encoder.py).

``fused_encoder_block(x, w_dil, b_dil, w_res, b_res, dilation)`` is
``x + relu(conv3_d(relu x) + b_dil) @ w_res[0] + b_res`` (non-causal SAME
padding) on [T, C] or [B, T, C] activations. A batch of clips is flattened
to [B*T, C] and run as one launch whose reads stop at each clip's edge, as
the JAX vmap rule does (pallas_encoder.py:414-454).

The forward is K7f and the waveform backward K7b. Unlike the chained trunk
(ops/chain.py) nothing is stashed: K7b recomputes the gate from x. Both have
two implementations, chosen by the tensor's dtype as K1 and K2 are:
bfloat16 runs on the tensor cores (csrc/trunk_mma.cu), float32 as float32
FMAs (csrc/trunk.cu). On CPU tensors each wrapper runs its plain
version (``block_fwd_plain`` / ``block_bwd_plain``, the kernels' cast
points); on a CUDA tensor it launches the kernel or raises. Weight
cotangents, when asked for, come from autograd through
``reference_encoder_block`` (a recompute, as the JAX custom VJP does).

``valid_window=(lo, hi)`` (plain Python ints, in-clip rows, applied to every
clip) is the masked block of the JAX per-layer path under a window
(``wavenet_ae.py::encoder_trunk``: ``masked(enc + d)``): the output is zeroed
outside [max(lo, 0), min(hi, clip_rows)), and the backward zeroes the output
cotangent there. ``None`` is the full range, bit for bit.
"""

from __future__ import annotations

import torch

from audio_style_transfer_tpu_torch.ops import _build
from audio_style_transfer_tpu_torch.ops.chain import (
    WIDTH,
    block_out_plain,
    check_cuda,
    check_layer,
    clamp_window,
    dilated_conv_plain,
    kernel_entry,
    transposed_conv_plain,
    window_rows,
    zero_outside,
)
from audio_style_transfer_tpu_torch.ops.conv import conv1d

_F32 = torch.float32


def block_fwd_plain(x, wd, bd, wr, br, d: int, clip_rows: int, valid_window=None):
    """Plain version of K7f: the block output on [rows, C], zero outside the
    window."""
    out = block_out_plain(x, dilated_conv_plain(x, wd, bd, d, clip_rows), wr, br)
    return zero_outside(out, window_rows(valid_window, x.shape[0], clip_rows, x.device))


def block_bwd_plain(x, g, wd, bd, wr, d: int, clip_rows: int, valid_window=None):
    """Plain version of K7b: dx of the block from its input x and output
    cotangent g, with the gate recomputed from x (pallas_encoder.py:337-362);
    the window zeroes g."""
    dt = x.dtype
    g = zero_outside(g, window_rows(valid_window, x.shape[0], clip_rows, x.device))
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


def _check_block(x, g, clip_rows: int) -> None:
    check_layer(x, clip_rows)
    check_cuda("x", x, x.shape, x.dtype, x.device)
    if g is not None:
        check_cuda("g", g, x.shape, x.dtype, x.device)


def _block_fwd_cuda(x, wd, bd, wr, br, d: int, clip_rows: int, valid_window):
    """Launch K7f on CUDA tensors: the tensor-core kernel for bfloat16, the
    float32-FMA kernel for float32."""
    _check_block(x, None, clip_rows)
    _check_weights(wd, bd, wr, br, x.dtype, x.device)
    out = torch.empty_like(x)
    args = (x.data_ptr(), wd.data_ptr(), bd.data_ptr(), wr.data_ptr(), br.data_ptr(),
            out.data_ptr(), x.shape[0], clip_rows, d, *clamp_window(valid_window, clip_rows))
    name = kernel_entry("ast_encoder_fwd", x.dtype)
    _build.check(getattr(_build.lib(), name)(*args, _build.stream_ptr(x.device)), name)
    _build.LAUNCHES["K7f"] += 1
    return out


def _block_bwd_cuda(x, g, wd, bd, wr, d: int, clip_rows: int, valid_window):
    """Launch K7b (both phases) on CUDA tensors, by dtype as
    ``_block_fwd_cuda``."""
    _check_block(x, g, clip_rows)
    _check_weights(wd, bd, wr, None, x.dtype, x.device)
    dy = torch.empty_like(x)
    dx = torch.empty_like(x)
    args = (x.data_ptr(), g.data_ptr(), wd.data_ptr(), bd.data_ptr(), wr.data_ptr(),
            dy.data_ptr(), dx.data_ptr(), x.shape[0], clip_rows, d,
            *clamp_window(valid_window, clip_rows))
    name = kernel_entry("ast_encoder_bwd", x.dtype)
    _build.check(getattr(_build.lib(), name)(*args, _build.stream_ptr(x.device)), name)
    _build.LAUNCHES["K7b"] += 1
    return dx


def block_fwd(x, wd, bd, wr, br, d: int, clip_rows: int, valid_window=None):
    """One block forward: K7f on CUDA (bfloat16: the tensor-core kernel of
    csrc/trunk_mma.cu; float32: the FMA kernel of csrc/trunk.cu), the plain
    version on the CPU.

    x [rows, C] (rows = clips * clip_rows), wd [3, C, C], wr [C, C] in x's
    dtype; bd, br [C] float32; valid_window (lo, hi) in in-clip rows or None."""
    if x.device.type == "cpu":
        return block_fwd_plain(x, wd, bd, wr, br, d, clip_rows, valid_window)
    return _block_fwd_cuda(x, wd, bd, wr, br, d, clip_rows, valid_window)


def block_bwd(x, g, wd, bd, wr, d: int, clip_rows: int, valid_window=None):
    """One block's dx: K7b on CUDA (bfloat16: csrc/trunk_mma.cu; float32:
    csrc/trunk.cu), the plain version on the CPU."""
    if x.device.type == "cpu":
        return block_bwd_plain(x, g, wd, bd, wr, d, clip_rows, valid_window)
    return _block_bwd_cuda(x, g, wd, bd, wr, d, clip_rows, valid_window)


def reference_encoder_block(x, w_dil, b_dil, w_res, b_res, dilation: int, valid_window=None):
    """Unfused composition of the same block through ops.conv (the JAX
    ``reference_encoder_block``; with a window, the JAX per-layer path's
    ``masked(enc + d)``). x is [T, C] or [B, T, C]."""
    xb = x[None] if x.dim() == 2 else x
    y = conv1d(torch.relu(xb), w_dil, b_dil, dilation=dilation, causal=False)
    out = zero_outside(xb + conv1d(torch.relu(y), w_res, b_res),
                        window_rows(valid_window, xb.shape[1], xb.shape[1], xb.device))
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
    def forward(ctx, x, w_dil, b_dil, w_res, b_res, dilation, valid_window=None):
        b, t, c = x.shape
        wd, bd, wr, br = _kernel_weights(x, w_dil, b_dil, w_res, b_res)
        out = block_fwd(x.reshape(b * t, c).contiguous(), wd, bd, wr, br, dilation, t,
                        valid_window)
        ctx.save_for_backward(x, w_dil, b_dil, w_res, b_res)
        ctx.dilation, ctx.valid_window = dilation, valid_window
        return out.view(b, t, c)

    @staticmethod
    def backward(ctx, g):
        x, w_dil, b_dil, w_res, b_res = ctx.saved_tensors
        d, valid_window = ctx.dilation, ctx.valid_window
        b, t, c = x.shape
        dx = dwd = dbd = dwr = dbr = None
        if ctx.needs_input_grad[0]:
            wd, bd, wr, _ = _kernel_weights(x, w_dil, b_dil, w_res, b_res)
            dx = block_bwd(x.reshape(b * t, c).contiguous(),
                           g.reshape(b * t, c).to(x.dtype).contiguous(),
                           wd, bd, wr, d, t, valid_window).view(b, t, c)
        if any(ctx.needs_input_grad[1:5]):
            with torch.enable_grad():
                ws = [w.detach().requires_grad_(True) for w in (w_dil, b_dil, w_res, b_res)]
                out = reference_encoder_block(x.detach(), *ws, d, valid_window)
                dwd, dbd, dwr, dbr = torch.autograd.grad(out, ws, g)
        return dx, dwd, dbd, dwr, dbr, None, None


def fused_encoder_block(x, w_dil, b_dil, w_res, b_res, dilation: int, valid_window=None):
    """Fused residual encoder block on [T, C] or [B, T, C] activations:
    w_dil [3, C, C], b_dil [C], w_res [1, C, C], b_res [C]; valid_window
    (lo, hi) Python ints in in-clip rows, or None."""
    d = int(dilation)
    if valid_window is not None:
        valid_window = (int(valid_window[0]), int(valid_window[1]))
    if x.dim() == 2:
        return EncoderBlockFunction.apply(x[None], w_dil, b_dil, w_res, b_res, d,
                                          valid_window)[0]
    return EncoderBlockFunction.apply(x, w_dil, b_dil, w_res, b_res, d, valid_window)
