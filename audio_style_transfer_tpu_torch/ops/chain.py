"""Encoder trunk with hand-written CUDA kernels (counterpart of
audio_style_transfer_tpu/ops/pallas_chain.py).

The trunk is the stack of residual blocks
``x_{j+1} = x_j + relu(conv3_d(relu x_j) + b_d) @ W_res + b_res`` on
[T, 128] activations. Its forward (K1, csrc/trunk.cu) runs one layer per
launch and stashes one mask byte per element (bit 0: x_{j+1} > 0, bit 1:
the gate y_j > 0; the first layer also writes the trunk input's relu mask).
Its backward (K2) computes the waveform cotangent from those masks alone,
four matmuls per layer, never reading an activation.

Which version runs is decided by the device of the tensors: on the CPU each
wrapper runs its plain torch version (``layer_fwd_plain``/``layer_bwd_plain``,
same cast points as the kernel); on a CUDA tensor it launches the kernel or
raises. Weight gradients, when asked for, come from autograd through the
plain ``reference_trunk`` (a recompute, as the JAX custom VJP does).
"""

from __future__ import annotations

import torch

from audio_style_transfer_tpu_torch.ops import _build
from audio_style_transfer_tpu_torch.ops.conv import conv1d

WIDTH = 128  # the kernels' compiled channel count
_F32 = torch.float32
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def stack_trunk_weights(params, num_layers: int = 30):
    """[K,3,C,C] / [K,C] / [K,C,C] / [K,C] stacks of the ae_dilatedconv /
    ae_res weights."""
    layers = range(1, num_layers + 1)
    wd = torch.stack([params[f"ae_dilatedconv_{k}"]["w"] for k in layers])
    bd = torch.stack([params[f"ae_dilatedconv_{k}"]["b"] for k in layers])
    wr = torch.stack([params[f"ae_res_{k}"]["w"][0] for k in layers])
    br = torch.stack([params[f"ae_res_{k}"]["b"] for k in layers])
    return wd, bd, wr, br


def reference_trunk(x, wd, bd, wr, br, dils, emit):
    """Unfused oracle through ops.conv (JAX ``reference_trunk``): the taps
    of ``emit`` in ascending order. x is [T, C] or [B, T, C]."""
    squeeze = x.dim() == 2
    cur = x[None] if squeeze else x
    taps = {}
    for j, d in enumerate(dils):
        y = conv1d(torch.relu(cur), wd[j], bd[j], dilation=d, causal=False)
        cur = cur + conv1d(torch.relu(y), wr[j][None], br[j])
        if j in emit:
            taps[j] = cur[0] if squeeze else cur
    return tuple(taps[j] for j in sorted(taps))


def _shift_rows(a: torch.Tensor, off: int, clip_rows: int) -> torch.Tensor:
    """Row r of the result is a[r + off] within r's clip, zero outside it.
    a is [rows, C] with rows a multiple of clip_rows."""
    if off == 0:
        return a
    c = a.shape[-1]
    clips = a.reshape(-1, clip_rows, c)
    if abs(off) >= clip_rows:
        return torch.zeros_like(a)
    zeros = clips.new_zeros(clips.shape[0], abs(off), c)
    if off > 0:
        shifted = torch.cat([clips[:, off:], zeros], dim=1)
    else:
        shifted = torch.cat([zeros, clips[:, :off]], dim=1)
    return shifted.reshape(a.shape)


def _masks(out, y):
    return (out > 0).to(torch.uint8) | ((y > 0).to(torch.uint8) << 1)


def dilated_conv_plain(x, wd, bd, d: int, clip_rows: int):
    """y = conv3_d(relu x) + bd in float32 (the gate's pre-activation)."""
    r = torch.relu(x).to(_F32)
    y = (_shift_rows(r, -d, clip_rows) @ wd[0].to(_F32)
         + r @ wd[1].to(_F32)
         + _shift_rows(r, d, clip_rows) @ wd[2].to(_F32))
    return y + bd.to(_F32)


def block_out_plain(x, y, wr, br):
    """The block output x + round(relu(y)_rounded @ Wr + br)."""
    dt = x.dtype
    v = torch.relu(y).to(dt)
    z = v.to(_F32) @ wr.to(_F32) + br.to(_F32)
    return x + z.to(dt)


def transposed_conv_plain(dy, wd, d: int, clip_rows: int):
    """dr[t] = dy[t+d] W0^T + dy[t] W1^T + dy[t-d] W2^T in float32."""
    return (_shift_rows(dy, d, clip_rows) @ wd[0].to(_F32).T
            + dy @ wd[1].to(_F32).T
            + _shift_rows(dy, -d, clip_rows) @ wd[2].to(_F32).T)


def layer_fwd_plain(x, wd, bd, wr, br, d: int, clip_rows: int,
                    want_inmask: bool = False):
    """Plain version of K1 for one layer: (out, mask, inmask or None)."""
    y = dilated_conv_plain(x, wd, bd, d, clip_rows)
    out = block_out_plain(x, y, wr, br)
    inmask = (x > 0).to(torch.uint8) if want_inmask else None
    return out, _masks(out, y), inmask


def layer_bwd_plain(dxn, dtap, mask, inmask, wd, wr, d: int, clip_rows: int):
    """Plain version of K2 for one layer: the cotangent of the layer input
    from the output cotangent ``dxn``, the emitted tap's cotangent ``dtap``
    (or None), this layer's mask bytes and the input's relu mask (bit 0)."""
    dt = dxn.dtype
    g = dxn if dtap is None else dxn + dtap
    dv = g.to(_F32) @ wr.to(_F32).T
    dy = (dv * ((mask >> 1) & 1).to(_F32)).to(dt).to(_F32)
    dr = transposed_conv_plain(dy, wd, d, clip_rows)
    return g + (dr * (inmask & 1).to(_F32)).to(dt)


def check_cuda(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_layer(x, clip_rows):
    if x.device.type != "cuda":
        raise RuntimeError(f"trunk kernels run on CUDA tensors, got {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"trunk kernels take float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] != WIDTH:
        raise ValueError(f"trunk kernels take [rows, {WIDTH}], got {tuple(x.shape)}")
    if clip_rows <= 0 or x.shape[0] % clip_rows:
        raise ValueError(f"rows {x.shape[0]} must be a multiple of clip_rows {clip_rows}")


def layer_fwd(x, wd, bd, wr, br, d: int, clip_rows: int, want_inmask: bool = False):
    """One trunk layer forward: K1 on CUDA, the plain version on the CPU.

    x [rows, C] (rows = clips * clip_rows), wd [3, C, C], wr [C, C] in x's
    dtype; bd, br [C] float32. Returns (out, mask, inmask or None)."""
    if x.device.type == "cpu":
        return layer_fwd_plain(x, wd, bd, wr, br, d, clip_rows, want_inmask)
    check_layer(x, clip_rows)
    c, dev, dt = WIDTH, x.device, x.dtype
    check_cuda("x", x, x.shape, dt, dev)
    check_cuda("wd", wd, (3, c, c), dt, dev)
    check_cuda("wr", wr, (c, c), dt, dev)
    check_cuda("bd", bd, (c,), _F32, dev)
    check_cuda("br", br, (c,), _F32, dev)
    out = torch.empty_like(x)
    mask = torch.empty(x.shape, dtype=torch.uint8, device=dev)
    inmask = torch.empty_like(mask) if want_inmask else None
    status = _build.lib().ast_trunk_fwd(
        x.data_ptr(), wd.data_ptr(), bd.data_ptr(), wr.data_ptr(), br.data_ptr(),
        out.data_ptr(), mask.data_ptr(),
        inmask.data_ptr() if inmask is not None else None,
        x.shape[0], clip_rows, d, int(dt == torch.bfloat16), _build.stream_ptr(dev))
    _build.check(status, "ast_trunk_fwd")
    _build.LAUNCHES["K1"] += 1
    return out, mask, inmask


def layer_bwd(dxn, dtap, mask, inmask, wd, wr, d: int, clip_rows: int):
    """One trunk layer backward: K2 on CUDA, the plain version on the CPU."""
    if dxn.device.type == "cpu":
        return layer_bwd_plain(dxn, dtap, mask, inmask, wd, wr, d, clip_rows)
    check_layer(dxn, clip_rows)
    c, dev, dt = WIDTH, dxn.device, dxn.dtype
    check_cuda("dxn", dxn, dxn.shape, dt, dev)
    if dtap is not None:
        check_cuda("dtap", dtap, dxn.shape, dt, dev)
    check_cuda("mask", mask, dxn.shape, torch.uint8, dev)
    check_cuda("inmask", inmask, dxn.shape, torch.uint8, dev)
    check_cuda("wd", wd, (3, c, c), dt, dev)
    check_cuda("wr", wr, (c, c), dt, dev)
    dy = torch.empty_like(dxn)
    dx = torch.empty_like(dxn)
    status = _build.lib().ast_trunk_bwd(
        dxn.data_ptr(), dtap.data_ptr() if dtap is not None else None,
        mask.data_ptr(), inmask.data_ptr(), wd.data_ptr(), wr.data_ptr(),
        dy.data_ptr(), dx.data_ptr(), dxn.shape[0], clip_rows, d,
        int(dt == torch.bfloat16), _build.stream_ptr(dev))
    _build.check(status, "ast_trunk_bwd")
    _build.LAUNCHES["K2"] += 1
    return dx


def trunk_forward(x2d, wd, bd, wr, br, dils, clip_rows: int):
    """All layers forward on [rows, C]: (outs per layer, masks per layer,
    input relu mask). Weights are cast to the activation dtype, biases to
    float32, as the kernels take them."""
    dt = x2d.dtype
    wd, wr = wd.to(dt).contiguous(), wr.to(dt).contiguous()
    bd, br = bd.to(_F32).contiguous(), br.to(_F32).contiguous()
    outs, masks, inmask = [], [], None
    cur = x2d
    for j, d in enumerate(dils):
        cur, m, im = layer_fwd(cur, wd[j], bd[j], wr[j], br[j], d, clip_rows,
                               want_inmask=(j == 0))
        if j == 0:
            inmask = im
        outs.append(cur)
        masks.append(m)
    return outs, masks, inmask


def trunk_backward(dtaps: dict, masks, inmask, wd, wr, dils, clip_rows: int):
    """Waveform cotangent of the trunk input from tap cotangents
    ({layer: [rows, C] or None}); the last layer's seeds the chain."""
    last = len(dils) - 1
    seed = dtaps.get(last)
    if seed is None:
        raise ValueError("trunk_backward needs the last tap's cotangent")
    dt = seed.dtype
    wd, wr = wd.to(dt).contiguous(), wr.to(dt).contiguous()
    dx = seed
    for j in range(last, -1, -1):
        dtap = dtaps.get(j) if j != last else None
        in_m = masks[j - 1] if j > 0 else inmask
        dx = layer_bwd(dx, dtap, masks[j], in_m, wd[j], wr[j], dils[j], clip_rows)
    return dx


class TrunkFunction(torch.autograd.Function):
    """Whole-trunk op: x [B, T, C] -> the taps of ``emit`` (ascending,
    including the last layer). Forward through K1, waveform gradient
    through K2; weight gradients by recompute through ``reference_trunk``
    only when asked for."""

    @staticmethod
    def forward(ctx, x, wd, bd, wr, br, dils, emit):
        b, t, c = x.shape
        outs, masks, inmask = trunk_forward(
            x.reshape(b * t, c).contiguous(), wd, bd, wr, br, dils, t)
        ctx.save_for_backward(x, wd, bd, wr, br, inmask, *masks)
        ctx.dils, ctx.emit = dils, emit
        ctx.set_materialize_grads(False)
        return tuple(outs[j].view(b, t, c) for j in emit)

    @staticmethod
    def backward(ctx, *dtaps):
        x, wd, bd, wr, br, inmask, *masks = ctx.saved_tensors
        dils, emit = ctx.dils, ctx.emit
        b, t, c = x.shape
        dx = dwd = dbd = dwr = dbr = None
        if ctx.needs_input_grad[0]:
            flat = {
                j: g.reshape(b * t, c).to(x.dtype).contiguous()
                for j, g in zip(emit, dtaps) if g is not None
            }
            last = len(dils) - 1
            if last not in flat:
                flat[last] = x.new_zeros(b * t, c)
            dx = trunk_backward(flat, masks, inmask, wd, wr, dils, t).view(b, t, c)
        if any(ctx.needs_input_grad[1:5]):
            with torch.enable_grad():
                ws = [w.detach().requires_grad_(True) for w in (wd, bd, wr, br)]
                taps = reference_trunk(x.detach(), *ws, dils, emit)
                pairs = [(tp, g) for tp, g in zip(taps, dtaps) if g is not None]
                dwd, dbd, dwr, dbr = torch.autograd.grad(
                    [p[0] for p in pairs], ws, [p[1] for p in pairs],
                    allow_unused=True)
        return dx, dwd, dbd, dwr, dbr, None, None


def fused_trunk(x, wd, bd, wr, br, dils, emit):
    """The trunk's taps of ``emit`` (the last layer is always added), in
    ascending layer order. x is [B, T, C] or [T, C]."""
    dils = tuple(int(d) for d in dils)
    emit = tuple(sorted(set(int(e) for e in emit) | {len(dils) - 1}))
    if x.dim() == 2:
        return tuple(tp[0] for tp in TrunkFunction.apply(x[None], wd, bd, wr, br, dils, emit))
    return TrunkFunction.apply(x, wd, bd, wr, br, dils, emit)
