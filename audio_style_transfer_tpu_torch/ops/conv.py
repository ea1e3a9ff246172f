"""1-D convolution primitives (counterpart of audio_style_transfer_tpu/ops/conv.py).

Plain torch: the JAX package leaves these ops to XLA. Layout [B, T, C],
weights [F, Cin, Cout]. Padding matches the reference (tests/test_conv.py):
non-causal is a symmetric pad of ((F-1)//2 * d), causal a left pad of
(F-1)*d. Products accumulate in float32 and the result is cast back to the
input's dtype, as the JAX path does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _shifted(x: torch.Tensor, filter_length: int, dilation: int, causal: bool):
    """The F time-shifted views of x [B, T, C]: view k holds x[t + o_k]
    (zero off the edge), o_k = -pad_left + k * dilation."""
    span = (filter_length - 1) * dilation
    pad_left = span if causal else span // 2
    t = x.shape[1]
    xp = F.pad(x, (0, 0, pad_left, span - pad_left))
    return [xp[:, k * dilation : k * dilation + t] for k in range(filter_length)]


def conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
           dilation: int = 1, causal: bool = True) -> torch.Tensor:
    """Dilated 1-D convolution: x [B, T, Cin], w [F, Cin, Cout] -> [B, T, Cout]."""
    filter_length = w.shape[0]
    if w.shape[1] == 1 and filter_length > 1:
        return _conv1d_one_in_channel(x, w, b, dilation, causal)
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
