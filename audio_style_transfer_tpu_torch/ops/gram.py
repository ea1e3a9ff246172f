"""All-pairs channel gram with hand-written CUDA kernels (counterpart of
audio_style_transfer_tpu/ops/pallas_gram.py).

``pair_gram(*taps)`` maps L taps, each [B, T, C], to
``G[n, a, b, c] = sum_t taps[a][n, t, c] * taps[b][n, t, c]`` in float32
whatever the taps' dtype. The forward is K5 (csrc/gram.cu) on CUDA tensors
and the plain einsum (``pair_gram_reference``) on CPU tensors.

The backward follows the JAX routing (pallas_gram.py ``_vjp_bwd``): with
h = g + g^T in float32, ``dE_a = sum_b h[:, a, b] * E_b``. For L <= 15 taps
and T <= 32768 it is the plain composition, which is what JAX itself runs
there (the stack-0 path). Beyond that (the full stack, L=30) it is
``pair_gram_bwd``: K6 (csrc/gram.cu) on CUDA tensors, the plain composition
on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from audio_style_transfer_tpu_torch.ops import _build

PLAIN_BWD_MAX_L = 15
PLAIN_BWD_MAX_T = 32768
MAX_TAPS = 32       # taps per K5 or K6 launch
CHANNEL_BLOCK = 32  # K5 needs C to be a multiple of this
CHUNK = 256         # time rows per K5 partial sum
BWD_CHANNEL_BLOCK = 16  # K6 needs C to be a multiple of this


def pair_gram_reference(*taps: torch.Tensor) -> torch.Tensor:
    """Plain version: float32 einsum over the stacked taps -> [B, L, L, C]."""
    stacked = torch.stack([t.to(torch.float32) for t in taps], dim=1)
    return torch.einsum("nats,nbts->nabs", stacked, stacked)


def _check_taps(taps, channel_block: int) -> None:
    t0 = taps[0]
    if t0.device.type != "cuda":
        raise RuntimeError(f"the gram kernel runs on CUDA tensors, got {t0.device}")
    if not 1 <= len(taps) <= MAX_TAPS:
        raise ValueError(f"the gram kernels take 1..{MAX_TAPS} taps, got {len(taps)}")
    if t0.dim() != 3 or t0.shape[2] % channel_block:
        raise ValueError(
            f"taps must be [B, T, C] with C a multiple of {channel_block}, "
            f"got {tuple(t0.shape)}")
    if t0.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the gram kernel takes float32 or bfloat16, got {t0.dtype}")
    for i, t in enumerate(taps):
        if t.device != t0.device or t.dtype != t0.dtype or t.shape != t0.shape:
            raise ValueError(f"tap {i} differs from tap 0 in device, dtype or shape")
        if not t.is_contiguous():
            raise ValueError(f"tap {i} must be contiguous")


def pair_gram_fwd(*taps: torch.Tensor) -> torch.Tensor:
    """The gram forward: K5 on CUDA, the plain version on the CPU."""
    if taps[0].device.type == "cpu":
        return pair_gram_reference(*taps)
    _check_taps(taps, CHANNEL_BLOCK)
    nl = len(taps)
    b, t, c = taps[0].shape
    dev = taps[0].device
    n_chunks = -(-t // CHUNK)
    partial = torch.empty((b, n_chunks, nl, nl, c), dtype=torch.float32, device=dev)
    out = torch.empty((b, nl, nl, c), dtype=torch.float32, device=dev)
    ptrs = (ctypes.c_void_p * nl)(*[tp.data_ptr() for tp in taps])
    status = _build.lib().ast_pair_gram(
        ptrs, nl, b, t, c, CHUNK, int(taps[0].dtype == torch.bfloat16),
        partial.data_ptr(), out.data_ptr(), _build.stream_ptr(dev))
    _build.check(status, "ast_pair_gram")
    _build.LAUNCHES["K5"] += 1
    return out


def pair_gram_bwd_plain(taps, h: torch.Tensor):
    """dE_a = sum_b h[:, a, b, :] * E_b in float32, cast to each tap's dtype
    (the composition of JAX pallas_gram.py:226-233)."""
    fl = [t.to(torch.float32) for t in taps]
    outs = []
    for a in range(len(taps)):
        acc = h[:, a, 0, :][:, None, :] * fl[0]
        for b in range(1, len(taps)):
            acc = acc + h[:, a, b, :][:, None, :] * fl[b]
        outs.append(acc.to(taps[a].dtype))
    return tuple(outs)


def pair_gram_bwd(taps, h: torch.Tensor):
    """The gram backward given h = g + g^T ([B, L, L, C] float32): K6 on
    CUDA, the plain composition on the CPU. Returns one cotangent per tap,
    in the taps' dtype."""
    if taps[0].device.type == "cpu":
        return pair_gram_bwd_plain(taps, h)
    _check_taps(taps, BWD_CHANNEL_BLOCK)
    nl = len(taps)
    b, t, c = taps[0].shape
    if (h.device != taps[0].device or h.dtype != torch.float32
            or tuple(h.shape) != (b, nl, nl, c) or not h.is_contiguous()):
        raise ValueError(
            f"h must be a contiguous float32 [{b}, {nl}, {nl}, {c}] tensor on "
            f"{taps[0].device}, got {h.dtype} {tuple(h.shape)} on {h.device}")
    outs = [torch.empty_like(tp) for tp in taps]
    tap_ptrs = (ctypes.c_void_p * nl)(*[tp.data_ptr() for tp in taps])
    out_ptrs = (ctypes.c_void_p * nl)(*[o.data_ptr() for o in outs])
    status = _build.lib().ast_pair_gram_bwd(
        tap_ptrs, out_ptrs, nl, b, t, c, int(taps[0].dtype == torch.bfloat16),
        h.data_ptr(), _build.stream_ptr(taps[0].device))
    _build.check(status, "ast_pair_gram_bwd")
    _build.LAUNCHES["K6"] += 1
    return tuple(outs)


class PairGram(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *taps):
        ctx.save_for_backward(*taps)
        return pair_gram_fwd(*taps)

    @staticmethod
    def backward(ctx, g):
        taps = ctx.saved_tensors
        h = (g + g.transpose(1, 2)).to(torch.float32).contiguous()
        if len(taps) <= PLAIN_BWD_MAX_L and taps[0].shape[1] <= PLAIN_BWD_MAX_T:
            return pair_gram_bwd_plain(taps, h)
        return pair_gram_bwd(taps, h)


def pair_gram(*taps: torch.Tensor) -> torch.Tensor:
    """All-pairs channel-wise gram of L taps, each [B, T, C] -> [B, L, L, C]
    float32."""
    return PairGram.apply(*taps)
