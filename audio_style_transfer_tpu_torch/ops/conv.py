"""1-D convolution primitives (counterpart of audio_style_transfer_tpu/ops/conv.py).

Plain torch: the JAX package leaves these ops to XLA. Layout [B, T, C],
weights [F, Cin, Cout]. Padding matches the reference (tests/test_conv.py):
non-causal is a symmetric pad of ((F-1)//2 * d), causal a left pad of
(F-1)*d. Products accumulate in float32 and the result is cast back to the
input's dtype once, as the JAX path does: on the CPU and in float32 through
float32 products, one per tap; on bfloat16 CUDA tensors as one bfloat16
product on the tensor cores (the taps merged along the reduction axis), in
the forward and in both gradients, see ``conv1d``. The merged-taps operand
of a CUDA tensor is written by one hand-written kernel (``taps_pack``,
csrc/conv.cu); of a CPU tensor it is the plain pad and concatenation.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from audio_style_transfer_tpu_torch.ops import _build

ALIGN = 16  # bytes: the pack kernel moves 16-byte pieces
VEC = 8     # bf16 channels in a piece: the width must be a multiple of this


def _offsets(filter_length: int, dilation: int, causal: bool) -> list[int]:
    """o_k = -pad_left + k * dilation: tap k reads x[t + o_k]."""
    span = (filter_length - 1) * dilation
    pad_left = span if causal else span // 2
    return [k * dilation - pad_left for k in range(filter_length)]


def _shifted_by(x: torch.Tensor, offsets) -> list[torch.Tensor]:
    """Views of x [B, T, C], one per offset o: x[t + o], zero off the edge."""
    lo, hi = max(0, -min(offsets)), max(0, max(offsets))
    t = x.shape[1]
    xp = F.pad(x, (0, 0, lo, hi))
    return [xp[:, lo + o : lo + o + t] for o in offsets]


def _shifted(x: torch.Tensor, filter_length: int, dilation: int, causal: bool):
    """The F time-shifted views of x [B, T, C]: view k holds x[t + o_k]
    (zero off the edge)."""
    return _shifted_by(x, _offsets(filter_length, dilation, causal))


@contextlib.contextmanager
def _float32_reduction():
    """cuBLAS may reduce a split-K bfloat16 product in bfloat16 while
    ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
    is on (PyTorch's default): off inside, restored after."""
    m = torch.backends.cuda.matmul
    before = m.allow_bf16_reduced_precision_reduction
    m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        m.allow_bf16_reduced_precision_reduction = before


def taps_pack(x: torch.Tensor, offsets) -> torch.Tensor:
    """[B, T, F*C] with out[b, t, k*C + c] = x[b, t + o_k, c], zero off the
    clip, by the pack kernel (csrc/conv.cu) in one pass over x. x: a
    contiguous, 16-byte aligned bfloat16 CUDA tensor [B, T, C], C a multiple
    of 8; offsets: at least two, evenly spaced. Raises on anything else."""
    if x.dim() != 3:
        raise ValueError(f"taps_pack: x must be [B, T, C], got {tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"taps_pack: the kernel takes bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("taps_pack: x must be contiguous")
    b, t, c = x.shape
    if c % VEC:
        raise ValueError(f"taps_pack: C = {c} must be a multiple of {VEC}")
    f = len(offsets)
    step = offsets[1] - offsets[0] if f > 1 else 0
    if f < 2 or any(o != offsets[0] + k * step for k, o in enumerate(offsets)):
        raise ValueError(f"taps_pack: offsets {list(offsets)} are not two or more evenly "
                         "spaced taps")
    if x.device.type != "cuda":
        raise RuntimeError(f"taps_pack: the kernel runs on CUDA tensors, got {x.device}")
    if x.data_ptr() % ALIGN:
        raise ValueError(f"taps_pack: x must be aligned to {ALIGN} bytes")
    out = torch.empty((b, t, f * c), dtype=x.dtype, device=x.device)
    status = _build.lib().ast_taps_pack(x.data_ptr(), out.data_ptr(), b, t, c, f, offsets[0],
                                        step, _build.stream_ptr(x.device))
    _build.check(status, "ast_taps_pack")
    _build.LAUNCHES["taps_pack"] += 1
    return out


def _side_by_side(x: torch.Tensor, offsets) -> torch.Tensor:
    """[B, T, F*C]: the shifted views of x side by side along channels; x
    itself for the one tap [0]. A CUDA tensor takes the pack kernel
    (``taps_pack``), a CPU tensor the plain pad and concatenation."""
    if offsets == [0]:
        return x
    if x.is_cuda:
        return taps_pack(x, offsets)
    return torch.cat(_shifted_by(x, offsets), dim=-1)


class _MergedTapsConv(torch.autograd.Function):
    """y = sum_k x[t + o_k] @ w[k] as one product of the shifted inputs side
    by side, [B*T, F*Cin] @ [F*Cin, Cout]. Each gradient is one product too:
    dw = xs^T @ g, and dx[t] = sum_k g[t - o_k] @ w[k]^T as
    [B*T, F*Cout] @ [F*Cout, Cin]. Every product sums in float32 and rounds
    once to the operands' type (reduced-precision split-K off). An output
    that reaches no loss (the last decoder block's residual) gets no
    gradient and runs no product. The pack takes contiguous rows: a strided
    input or cotangent (an expanded one, say) is copied once first."""

    @staticmethod
    def forward(ctx, x, w, offsets):
        xs = _side_by_side(x.contiguous(), offsets)
        ctx.save_for_backward(xs, w)  # as autograd would keep it for xs @ w
        ctx.offsets = offsets
        ctx.set_materialize_grads(False)
        with _float32_reduction():
            return xs @ w.reshape(-1, w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        if g is None:
            return None, None, None
        xs, w = ctx.saved_tensors
        f, cin, cout = w.shape
        dx = dw = None
        with _float32_reduction():
            if ctx.needs_input_grad[0]:
                w_t = w.transpose(1, 2).reshape(f * cout, cin)
                dx = _side_by_side(g.contiguous(), [-o for o in ctx.offsets]) @ w_t
            if ctx.needs_input_grad[1]:
                dw = (xs.reshape(-1, f * cin).T @ g.reshape(-1, cout)).view(f, cin, cout)
        return dx, dw, None


def conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
           dilation: int = 1, causal: bool = True) -> torch.Tensor:
    """Dilated 1-D convolution: x [B, T, Cin], w [F, Cin, Cout] -> [B, T, Cout].

    bfloat16 on a CUDA tensor (x and w): one product [B*T, F*Cin] @
    [F*Cin, Cout] of the F shifted inputs side by side, bfloat16 in, float32
    sums, rounded to bfloat16 once, as XLA's conv rounds once; each gradient
    is one such product too (``_MergedTapsConv``). The products run with
    ``allow_bf16_reduced_precision_reduction`` off and leave the flag as
    they found it. Elsewhere: float32 products, one per tap, summed in
    float32 and cast once."""
    filter_length = w.shape[0]
    if w.shape[1] == 1 and filter_length > 1:
        return _conv1d_one_in_channel(x, w, b, dilation, causal)
    if x.is_cuda and x.dtype == w.dtype == torch.bfloat16:
        y = _MergedTapsConv.apply(x, w, _offsets(filter_length, dilation, causal))
        return y if b is None else y + b.to(x.dtype)
    f32 = torch.float32
    if filter_length == 1:
        y = x.to(f32) @ w[0].to(f32)
    else:
        y = None
        for k, xk in enumerate(_shifted(x, filter_length, dilation, causal)):
            term = xk.to(f32) @ w[k].to(f32)
            y = term if y is None else y + term
    y = y.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def _conv1d_one_in_channel(x, w, b, dilation: int, causal: bool):
    """in_channels == 1 (the front convs): shifted broadcast multiplies
    accumulated in float32, in filter order (JAX conv.py:89)."""
    f32 = torch.float32
    y = None
    for k, xk in enumerate(_shifted(x, w.shape[0], dilation, causal)):
        term = xk.to(f32) * w[k, 0].to(f32)
        y = term if y is None else y + term
    if b is not None:
        y = y + b.to(f32)
    return y.to(x.dtype)


def pool1d(x: torch.Tensor, window_length: int, mode: str = "avg",
           stride: int | None = None) -> torch.Tensor:
    """Non-overlapping 1-D pooling over time (reference masked.py:163-190)."""
    stride = stride or window_length
    b, t, c = x.shape
    if t % window_length or stride != window_length:
        raise ValueError("only non-overlapping pooling is used by the model")
    xr = x.reshape(b, t // window_length, window_length, c)
    if mode == "avg":
        return xr.mean(dim=2)
    if mode == "max":
        return xr.amax(dim=2)
    raise ValueError(f"unknown pooling mode {mode!r}")


def shift_right(x: torch.Tensor) -> torch.Tensor:
    """Shift time right by one, zero-filling t=0 (reference masked.py:24-37)."""
    return F.pad(x, (0, 0, 1, 0))[:, : x.shape[1], :]


def condition(x: torch.Tensor, encoding: torch.Tensor) -> torch.Tensor:
    """Broadcast-add a hop-rate encoding [B, F, C] onto a sample-rate signal
    [B, T, C], T a multiple of F (reference model.py:34-55)."""
    mb, length, channels = x.shape
    enc_mb, enc_length, enc_channels = encoding.shape
    if enc_mb != mb or enc_channels != channels or length % enc_length:
        raise ValueError(f"condition: cannot add {tuple(encoding.shape)} onto {tuple(x.shape)}")
    x = x.reshape(mb, enc_length, length // enc_length, channels)
    return (x + encoding[:, :, None, :]).reshape(mb, length, channels)
