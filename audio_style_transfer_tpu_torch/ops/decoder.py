"""The WaveNet decoder block's elementwise epilogues in hand-written CUDA
kernels (csrc/decoder.cu), forward and backward.

A decoder block (models/wavenet_ae.py::_decoder_block) keeps its products on
cuBLAS (ops/conv.py), called without their biases:
``y = conv1d(l, W_dil)`` [B, T, 2m], ``c = conv1d(encoding, W_cond)``
[B, F, 2m], ``r = conv1d(gated, W_res)`` [B, T, m] and
``k = conv1d(gated, W_skip)`` [B, T, skip]. What lies between them is here:

  ``decoder_gate``:     z = (y + b_dil) + (c + b_cond)[frame(t)],
                        gated = sigmoid(z[..., :m]) * tanh(z[..., m:])
  ``decoder_residual``: l' = l + (r + b_res), s' = s + (k + b_skip)

T is a multiple of F; row t reads frame t // (T / F). Each is a
``torch.autograd.Function``. The gate saves only y (and c and the biases) and
recomputes z in its backward, which gives dz and, in the same pass,
dc[b, f] = the sum of dz over the frame's rows; both biases' gradients are
dc's sums over (B, F). The residual saves nothing: the gradients of l' and s'
flow on to l and r, and s and k, unchanged, and the two biases' gradients are
their column sums.

Each wrapper runs the kernel for CUDA tensors (float32 or bfloat16, contiguous,
16-byte aligned, widths multiples of 8) and raises on anything else; for CPU
tensors it runs the plain version beside it, in any floating dtype. The plain
versions round where the kernels round: the forwards are the eager
expressions themselves, the backwards compute in float32 (float64 for
float64) and round to the tensors' type after each product with the incoming
gradient and after each activation's gradient, as PyTorch's own backward
kernels do. The float32 sums (dc, the bias gradients) are returned in float32
and rounded by the caller.
"""

from __future__ import annotations

import torch

from audio_style_transfer_tpu_torch.ops import _build
from audio_style_transfer_tpu_torch.ops.conv import condition

ALIGN = 16     # bytes: the kernels move 16-byte pieces
VEC = 8        # channels a thread owns: every width is a multiple of this
SLICE = 64     # columns a block of the residual backward sums
DTYPES = (torch.float32, torch.bfloat16)


def _on_cpu(name: str, *tensors) -> bool:
    """Whether the tensors (None skipped) are CPU tensors; they must share one
    device."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"{name}: the tensors lie on {sorted(map(str, devices))}; "
                         "they must share one device")
    return devices.pop().type == "cpu"


def _check(name: str, **tensors) -> None:
    """Raise unless every tensor is a contiguous, aligned CUDA tensor of the
    first one's dtype (float32 or bfloat16)."""
    first = next(iter(tensors.values()))
    if first.device.type != "cuda":
        raise RuntimeError(f"{name}: the kernel runs on CUDA tensors, got {first.device}")
    if first.dtype not in DTYPES:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, got {first.dtype}")
    for key, t in tensors.items():
        if t.dtype != first.dtype:
            raise TypeError(f"{name}: {key} is {t.dtype}, not {first.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.data_ptr() % ALIGN:
            raise ValueError(f"{name}: {key} must be aligned to {ALIGN} bytes")


def _gate_shapes(name: str, y, c, b_dil, b_cond) -> tuple[int, int, int, int]:
    """(B, T, m, hop) of the gate's operands, or raise."""
    if y.dim() != 3 or c.dim() != 3 or y.shape[2] % 2:
        raise ValueError(f"{name}: y [B, T, 2m] and c [B, F, 2m], got {tuple(y.shape)} and "
                         f"{tuple(c.shape)}")
    b, t, width = y.shape
    if c.shape[0] != b or c.shape[2] != width or c.shape[1] < 1 or t % c.shape[1]:
        raise ValueError(f"{name}: c {tuple(c.shape)} does not condition y {tuple(y.shape)}: "
                         "T must be a multiple of the frame count")
    if tuple(b_dil.shape) != (width,) or tuple(b_cond.shape) != (width,):
        raise ValueError(f"{name}: the biases must be [{width}], got {tuple(b_dil.shape)} and "
                         f"{tuple(b_cond.shape)}")
    return b, t, width // 2, t // c.shape[1]


def _opmath(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def gate_fwd_plain(y, c, b_dil, b_cond):
    """gated = sigmoid(z[..., :m]) * tanh(z[..., m:]) in the tensors' dtype."""
    z = condition(y + b_dil, c + b_cond)
    m = z.shape[2] // 2
    return torch.sigmoid(z[..., :m]) * torch.tanh(z[..., m:])


def gate_bwd_plain(y, c, b_dil, b_cond, dgated):
    """(dz in the tensors' dtype, dc [B, F, 2m] in float32 or float64)."""
    dt, acc = y.dtype, _opmath(y.dtype)
    z = condition(y + b_dil, c + b_cond)
    m = z.shape[2] // 2
    s = torch.sigmoid(z[..., :m]).to(acc)
    th = torch.tanh(z[..., m:]).to(acc)
    g = dgated.to(acc)
    dz = torch.cat([((g * th).to(dt).to(acc) * (1 - s) * s).to(dt),
                    ((g * s).to(dt).to(acc) * (1 - th * th)).to(dt)], dim=2)
    b, t, width = dz.shape
    frames = c.shape[1]
    return dz, dz.to(acc).reshape(b, frames, t // frames, width).sum(2)


def residual_fwd_plain(l, s, r, k, b_res, b_skip):
    """(l + (r + b_res), s + (k + b_skip)) in the tensors' dtype."""
    return l + (r + b_res), s + (k + b_skip)


def residual_bwd_plain(dl, ds):
    """The column sums of dl and ds (either may be None) in float32 or float64."""
    return tuple(None if g is None
                 else g.reshape(-1, g.shape[-1]).sum(0, dtype=_opmath(g.dtype)) for g in (dl, ds))


def gate_fwd(y, c, b_dil, b_cond):
    """The gate forward: the kernel on CUDA, the plain version on the CPU."""
    on_cpu = _on_cpu("gate_fwd", y, c, b_dil, b_cond)
    b, t, m, hop = _gate_shapes("gate_fwd", y, c, b_dil, b_cond)
    if on_cpu:
        return gate_fwd_plain(y, c, b_dil, b_cond)
    _check("gate_fwd", y=y, c=c, b_dil=b_dil, b_cond=b_cond)
    if m % VEC:
        raise ValueError(f"gate_fwd: m = {m} must be a multiple of {VEC}")
    gated = torch.empty((b, t, m), dtype=y.dtype, device=y.device)
    status = _build.lib().ast_decoder_gate_fwd(
        y.data_ptr(), c.data_ptr(), b_dil.data_ptr(), b_cond.data_ptr(), gated.data_ptr(),
        b * t, m, hop, int(y.dtype == torch.bfloat16), _build.stream_ptr(y.device))
    _build.check(status, "ast_decoder_gate_fwd")
    _build.LAUNCHES["gate_fwd"] += 1
    return gated


def gate_bwd(y, c, b_dil, b_cond, dgated):
    """The gate backward: (dz, dc float32) by the kernel on CUDA, the plain
    version on the CPU."""
    on_cpu = _on_cpu("gate_bwd", y, c, b_dil, b_cond, dgated)
    b, t, m, hop = _gate_shapes("gate_bwd", y, c, b_dil, b_cond)
    if tuple(dgated.shape) != (b, t, m):
        raise ValueError(f"gate_bwd: dgated must be [{b}, {t}, {m}], got {tuple(dgated.shape)}")
    if on_cpu:
        return gate_bwd_plain(y, c, b_dil, b_cond, dgated)
    _check("gate_bwd", y=y, c=c, b_dil=b_dil, b_cond=b_cond, dgated=dgated)
    if m % VEC:
        raise ValueError(f"gate_bwd: m = {m} must be a multiple of {VEC}")
    dz = torch.empty_like(y)
    dc = torch.empty(c.shape, dtype=torch.float32, device=y.device)
    status = _build.lib().ast_decoder_gate_bwd(
        y.data_ptr(), c.data_ptr(), b_dil.data_ptr(), b_cond.data_ptr(), dgated.data_ptr(),
        dz.data_ptr(), dc.data_ptr(), b * t, m, hop, int(y.dtype == torch.bfloat16),
        _build.stream_ptr(y.device))
    _build.check(status, "ast_decoder_gate_bwd")
    _build.LAUNCHES["gate_bwd"] += 1
    return dz, dc


def _residual_shapes(name: str, l, s, r, k, b_res, b_skip) -> None:
    if l.dim() != 3 or r.shape != l.shape or s.dim() != 3 or k.shape != s.shape \
            or s.shape[:2] != l.shape[:2]:
        raise ValueError(f"{name}: l, r [B, T, C] and s, k [B, T, S] of one B and T, got "
                         f"{tuple(l.shape)}, {tuple(r.shape)}, {tuple(s.shape)}, "
                         f"{tuple(k.shape)}")
    if tuple(b_res.shape) != (l.shape[2],) or tuple(b_skip.shape) != (s.shape[2],):
        raise ValueError(f"{name}: the biases must be [{l.shape[2]}] and [{s.shape[2]}], got "
                         f"{tuple(b_res.shape)} and {tuple(b_skip.shape)}")


def residual_fwd(l, s, r, k, b_res, b_skip):
    """(l', s'): the kernel on CUDA, the plain version on the CPU."""
    on_cpu = _on_cpu("residual_fwd", l, s, r, k, b_res, b_skip)
    _residual_shapes("residual_fwd", l, s, r, k, b_res, b_skip)
    if on_cpu:
        return residual_fwd_plain(l, s, r, k, b_res, b_skip)
    _check("residual_fwd", l=l, s=s, r=r, k=k, b_res=b_res, b_skip=b_skip)
    if l.shape[2] % VEC or s.shape[2] % VEC:
        raise ValueError(f"residual_fwd: widths {l.shape[2]} and {s.shape[2]} must be "
                         f"multiples of {VEC}")
    l_out, s_out = torch.empty_like(l), torch.empty_like(s)
    status = _build.lib().ast_decoder_residual_fwd(
        l.data_ptr(), r.data_ptr(), b_res.data_ptr(), l_out.data_ptr(), l.shape[2],
        s.data_ptr(), k.data_ptr(), b_skip.data_ptr(), s_out.data_ptr(), s.shape[2],
        l.shape[0] * l.shape[1], int(l.dtype == torch.bfloat16), _build.stream_ptr(l.device))
    _build.check(status, "ast_decoder_residual_fwd")
    _build.LAUNCHES["residual_fwd"] += 1
    return l_out, s_out


def residual_chunk_rows(rows: int, slices: int, sms: int) -> int:
    """Rows a block of the residual backward sums: as many chunks as make the
    grid (slices x chunks) about 8 blocks an SM, no chunk under 256 rows."""
    chunks = max(1, min(-(-rows // 256), 8 * sms // slices, 65535))
    return -(-rows // chunks)


def residual_bwd(dl, ds):
    """The column sums of dl and ds (either may be None, its sum then None),
    float32: the kernel on CUDA, the plain version on the CPU."""
    grads = {key: g for key, g in (("dl", dl), ("ds", ds)) if g is not None}
    if not grads:
        return None, None
    on_cpu = _on_cpu("residual_bwd", *grads.values())
    first = next(iter(grads.values()))
    if any(g.dim() != 3 or g.shape[:2] != first.shape[:2] for g in grads.values()):
        raise ValueError(f"residual_bwd: [B, T, C] gradients of one B and T, got "
                         f"{[tuple(g.shape) for g in grads.values()]}")
    if on_cpu:
        return residual_bwd_plain(dl, ds)
    _check("residual_bwd", **grads)
    if any(g.shape[2] % VEC for g in grads.values()):
        raise ValueError(f"residual_bwd: widths must be multiples of {VEC}, got "
                         f"{[g.shape[2] for g in grads.values()]}")
    cl, cs = (0 if g is None else g.shape[2] for g in (dl, ds))
    rows = first.shape[0] * first.shape[1]
    slices = -(-cl // SLICE) + -(-cs // SLICE)
    chunk = residual_chunk_rows(rows, slices, _build.sm_count(first.device.index))
    scratch = torch.empty(-(-rows // chunk) * (cl + cs) + slices, dtype=torch.float32,
                          device=first.device)
    out = torch.empty(cl + cs, dtype=torch.float32, device=first.device)
    status = _build.lib().ast_decoder_residual_bwd(
        0 if dl is None else dl.data_ptr(), cl, 0 if ds is None else ds.data_ptr(), cs, rows,
        chunk, scratch.data_ptr(), out.data_ptr(), int(first.dtype == torch.bfloat16),
        _build.stream_ptr(first.device))
    _build.check(status, "ast_decoder_residual_bwd")
    _build.LAUNCHES["residual_bwd"] += 1
    return (None if dl is None else out[:cl]), (None if ds is None else out[cl:])


class DecoderGate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, c, b_dil, b_cond):
        ctx.save_for_backward(y, c, b_dil, b_cond)
        return gate_fwd(y, c, b_dil, b_cond)

    @staticmethod
    def backward(ctx, dgated):
        y, c, b_dil, b_cond = ctx.saved_tensors
        dz, dc = gate_bwd(y, c, b_dil, b_cond, dgated.contiguous())
        db = dc.sum((0, 1))
        return dz, dc.to(c.dtype), db.to(b_dil.dtype), db.to(b_cond.dtype)


class DecoderResidual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, l, s, r, k, b_res, b_skip):
        # A gradient that never comes stays None: the last block's l' feeds
        # nothing, so neither its res product nor b_res gets a backward.
        ctx.set_materialize_grads(False)
        ctx.bias_dtypes = (b_res.dtype, b_skip.dtype)
        return residual_fwd(l, s, r, k, b_res, b_skip)

    @staticmethod
    def backward(ctx, dl, ds):
        dl = None if dl is None else dl.contiguous()
        ds = None if ds is None else ds.contiguous()
        db_res, db_skip = residual_bwd(dl, ds)
        db_res = None if db_res is None else db_res.to(ctx.bias_dtypes[0])
        db_skip = None if db_skip is None else db_skip.to(ctx.bias_dtypes[1])
        return dl, ds, dl, ds, db_res, db_skip


def decoder_gate(y, c, b_dil, b_cond):
    """gated [B, T, m] of y [B, T, 2m], c [B, F, 2m] and the biases [2m]."""
    return DecoderGate.apply(y, c, b_dil, b_cond)


def decoder_residual(l, s, r, k, b_res, b_skip):
    """(l + (r + b_res), s + (k + b_skip))."""
    return DecoderResidual.apply(l, s, r, k, b_res, b_skip)
