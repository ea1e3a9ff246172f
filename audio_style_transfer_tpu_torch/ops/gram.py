"""All-pairs channel gram with hand-written CUDA kernels (counterpart of
audio_style_transfer_tpu/ops/pallas_gram.py).

``pair_gram(*taps)`` maps L taps, each [B, T, C], to
``G[n, a, b, c] = sum_t taps[a][n, t, c] * taps[b][n, t, c]`` in float32
whatever the taps' dtype. The forward is K5 (csrc/gram.cu) on CUDA tensors
and the plain einsum (``pair_gram_reference``) on CPU tensors.

The backward, with h = g + g^T in float32, is ``dE_a = sum_b h[:, a, b] *
E_b``: ``pair_gram_bwd``, which is K6 (csrc/gram.cu) on CUDA tensors at any
L and the plain composition (``pair_gram_bwd_plain``) on CPU tensors. The
JAX package keeps the plain composition for L <= 15 and T <= 32768
(pallas_gram.py ``_vjp_bwd``); that threshold is a profile of its own
device and is not taken over. On an NVIDIA H100 80GB HBM3 at 700 W (bf16,
T=16384, C=128) the plain composition at L=10 is some 200 launches and 2.2
ms, K6 one launch (PERF.md has the kernels' times).

``layer_gram(*taps)`` maps L taps, each [1, T, C], to the per-layer (Gatys)
grams ``G[l] = X_l^T X_l``, [L, C, C] float32: K8f forward and K8b backward
(csrc/gram.cu, ``LayerGram``) on CUDA tensors, the plain float32 matmul
(``layer_gram_reference``, differentiated by autograd) on CPU tensors. The
JAX package has no kernel for it (XLA's bf16 einsum, accumulated in float32);
the kernels read the bf16 taps where they lie, with no copy and no float32
cast.

Autograd runs ``PairGram``'s forward (K5, its reduce and their buffers)
inside the span ``gram.pair`` and its backward (h, its cast and K6) inside
``gram.pair_bwd``; ``LayerGram``'s inside ``gram.layer`` and
``gram.layer_bwd`` (``utils/profiling.py::span``).

The kernels' launch geometry is chosen here, by plain functions the CPU
tests reach: the tap bucket the kernels are compiled for, K5's time rows per
partial sum, K6's time rows per block, K8f's rows per block and K8b's (tap,
tile) pairs per block.
"""

from __future__ import annotations

import ctypes

import torch

from audio_style_transfer_tpu_torch.ops import _build
from audio_style_transfer_tpu_torch.utils.profiling import span

MAX_TAPS = 32           # taps per K5 or K6 launch
CHANNEL_BLOCK = 8       # K5 needs C to be a multiple of this
BWD_CHANNEL_BLOCK = 16  # K6 needs C to be a multiple of this
ALIGN = 16              # bytes: the kernels move 16-byte and 4-byte pieces
MIN_ROWS = 256          # fewest time rows a block is given
BWD_STEP = 32           # K6 walks its rows 32 at a time
# Blocks of K6 resident on an SM, by tap bucket (from the kernels' registers
# and shared memory; csrc/gram.cu).
BWD_RESIDENT = {8: 4, 16: 4, 24: 2, 32: 2}
LAYER_WIDTH = 128       # K8f / K8b take the encoder's width only
LAYER_ROWS = 64         # K8f's rows per block are a multiple of its stage
LAYER_TILE = 128        # K8b's rows per tile
LAYER_FWD_RESIDENT = 2  # K8f blocks resident on an SM (64 KB of shared memory)
LAYER_BWD_RESIDENT = 1  # K8b (160 KB bf16, 192 KB float32)


def tap_bucket(nl: int) -> int:
    """The tap count the kernels are compiled for: L rounded up to 8."""
    if not 1 <= nl <= MAX_TAPS:
        raise ValueError(f"the gram kernels take 1..{MAX_TAPS} taps, got {nl}")
    return -(-nl // 8) * 8


def fwd_chunk_rows(b: int, t: int, c: int, sms: int) -> int:
    """Time rows per K5 block: T is cut so that the grid (C / 8 channel
    groups x chunks x B) is about one block an SM, and no finer than
    MIN_ROWS. Each chunk leaves one partial sum per pair and channel."""
    chunks = max(1, sms // (b * (c // CHANNEL_BLOCK)))
    return max(-(-t // chunks), MIN_ROWS)


def fwd_scratch_shape(b: int, t: int, c: int, nl: int, rows: int) -> tuple:
    """K5's partial sums: the upper triangle's pairs, per chunk."""
    return (b, -(-t // rows), nl * (nl + 1) // 2, c)


def bwd_block_rows(b: int, t: int, c: int, nl: int, sms: int) -> int:
    """Time rows per K6 block, a multiple of BWD_STEP: as few as still make
    the grid (C / 16 channel groups x blocks x B) one wave of resident
    blocks, and no fewer than MIN_ROWS (h is staged once per block)."""
    slots = sms * BWD_RESIDENT[tap_bucket(nl)]
    per_group = max(1, slots // (b * (c // BWD_CHANNEL_BLOCK)))
    rows = -(-t // per_group)
    return max(-(-rows // BWD_STEP) * BWD_STEP, MIN_ROWS)


def layer_fwd_chunk_rows(t: int, nl: int, sms: int) -> int:
    """Time rows per K8f block: T cut into as many chunks a tap as make the
    grid (chunks x L) about one wave of resident blocks, a multiple of
    LAYER_ROWS and no fewer than MIN_ROWS. Each chunk leaves one partial
    gram."""
    chunks = max(1, sms * LAYER_FWD_RESIDENT // nl)
    rows = -(-t // chunks)
    return max(-(-rows // LAYER_ROWS) * LAYER_ROWS, MIN_ROWS)


def layer_bwd_pairs_per_block(t: int, nl: int, sms: int) -> int:
    """(tap, tile) pairs per K8b block: the L x ceil(T / LAYER_TILE) pairs
    split into one run a resident block, so the grid is one wave whatever L
    and T."""
    pairs = nl * -(-t // LAYER_TILE)
    return -(-pairs // min(pairs, sms * LAYER_BWD_RESIDENT))


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
        if t.data_ptr() % ALIGN:
            raise ValueError(f"tap {i} must be aligned to {ALIGN} bytes")


def _tap_ptrs(tensors):
    """A host array of the tensors' device pointers, as the kernels take them."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def pair_gram_fwd(*taps: torch.Tensor) -> torch.Tensor:
    """The gram forward: K5 on CUDA, the plain version on the CPU."""
    if taps[0].device.type == "cpu":
        return pair_gram_reference(*taps)
    _check_taps(taps, CHANNEL_BLOCK)
    nl = len(taps)
    b, t, c = taps[0].shape
    dev = taps[0].device
    rows = fwd_chunk_rows(b, t, c, _build.sm_count(dev.index))
    partial = torch.empty(fwd_scratch_shape(b, t, c, nl, rows), dtype=torch.float32, device=dev)
    out = torch.empty((b, nl, nl, c), dtype=torch.float32, device=dev)
    status = _build.lib().ast_pair_gram(
        _tap_ptrs(taps), nl, b, t, c, rows, int(taps[0].dtype == torch.bfloat16),
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
    dev = taps[0].device
    if (h.device != dev or h.dtype != torch.float32
            or tuple(h.shape) != (b, nl, nl, c) or not h.is_contiguous()
            or h.data_ptr() % ALIGN):
        raise ValueError(
            f"h must be a contiguous, {ALIGN}-byte aligned float32 [{b}, {nl}, {nl}, {c}] "
            f"tensor on {dev}, got {h.dtype} {tuple(h.shape)} on {h.device}")
    # One allocation for the L cotangents (each slice stays 16-byte aligned:
    # C is a multiple of 16), handed out as its L views.
    outs = torch.empty((nl, b, t, c), dtype=taps[0].dtype, device=dev).unbind(0)
    status = _build.lib().ast_pair_gram_bwd(
        _tap_ptrs(taps), _tap_ptrs(outs), nl, b, t, c,
        bwd_block_rows(b, t, c, nl, _build.sm_count(dev.index)),
        int(taps[0].dtype == torch.bfloat16), h.data_ptr(), _build.stream_ptr(dev))
    _build.check(status, "ast_pair_gram_bwd")
    _build.LAUNCHES["K6"] += 1
    return outs


class PairGram(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *taps):
        ctx.save_for_backward(*taps)
        with span("gram.pair"):
            return pair_gram_fwd(*taps)

    @staticmethod
    def backward(ctx, g):
        taps = ctx.saved_tensors
        with span("gram.pair_bwd"):
            h = (g + g.transpose(1, 2)).to(torch.float32).contiguous()
            return pair_gram_bwd(taps, h)


def pair_gram(*taps: torch.Tensor) -> torch.Tensor:
    """All-pairs channel-wise gram of L taps, each [B, T, C] -> [B, L, L, C]
    float32."""
    return PairGram.apply(*taps)


def layer_gram_reference(*taps: torch.Tensor) -> torch.Tensor:
    """Plain version: each tap's [C, T] x [T, C] product in float32 after a
    cast of the concatenated taps -> [L, C, C]."""
    stl = torch.cat(taps, dim=0).to(torch.float32).transpose(1, 2)  # [L, C, T]
    return torch.matmul(stl, stl.transpose(1, 2))


def _check_layer_taps(taps) -> None:
    _check_taps(taps, LAYER_WIDTH)
    if taps[0].shape[0] != 1 or taps[0].shape[2] != LAYER_WIDTH:
        raise ValueError(f"the per-layer gram kernels take taps [1, T, {LAYER_WIDTH}], "
                         f"got {tuple(taps[0].shape)}")


def layer_gram_fwd(*taps: torch.Tensor) -> torch.Tensor:
    """K8f (and its sum over the partial grams): [L, C, C] float32 of L CUDA
    taps, each [1, T, 128] in float32 or bf16."""
    _check_layer_taps(taps)
    nl, t = len(taps), taps[0].shape[1]
    dev = taps[0].device
    rows = layer_fwd_chunk_rows(t, nl, _build.sm_count(dev.index))
    c = LAYER_WIDTH
    partial = torch.empty((nl, -(-t // rows), c, c), dtype=torch.float32, device=dev)
    out = torch.empty((nl, c, c), dtype=torch.float32, device=dev)
    status = _build.lib().ast_layer_gram(
        _tap_ptrs(taps), nl, t, rows, int(taps[0].dtype == torch.bfloat16),
        partial.data_ptr(), out.data_ptr(), _build.stream_ptr(dev))
    _build.check(status, "ast_layer_gram")
    _build.LAUNCHES["K8f"] += 1
    return out


def layer_gram_bwd(taps, g: torch.Tensor):
    """K8b: dX_l = X_l (g_l^T + g_l) for the CUDA taps and the grams'
    gradient g ([L, C, C] float32), float32 sums rounded once to the taps'
    dtype. Returns one cotangent per tap."""
    _check_layer_taps(taps)
    nl, t = len(taps), taps[0].shape[1]
    dev, c = taps[0].device, LAYER_WIDTH
    if (g.device != dev or g.dtype != torch.float32 or tuple(g.shape) != (nl, c, c)
            or not g.is_contiguous() or g.data_ptr() % ALIGN):
        raise ValueError(
            f"g must be a contiguous, {ALIGN}-byte aligned float32 [{nl}, {c}, {c}] tensor on "
            f"{dev}, got {g.dtype} {tuple(g.shape)} on {g.device}")
    outs = torch.empty((nl, 1, t, c), dtype=taps[0].dtype, device=dev).unbind(0)
    status = _build.lib().ast_layer_gram_bwd(
        _tap_ptrs(taps), _tap_ptrs(outs), nl, t,
        layer_bwd_pairs_per_block(t, nl, _build.sm_count(dev.index)),
        int(taps[0].dtype == torch.bfloat16), g.data_ptr(), _build.stream_ptr(dev))
    _build.check(status, "ast_layer_gram_bwd")
    _build.LAUNCHES["K8b"] += 1
    return outs


class LayerGram(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *taps):
        ctx.save_for_backward(*taps)
        with span("gram.layer"):
            return layer_gram_fwd(*taps)

    @staticmethod
    def backward(ctx, g):
        with span("gram.layer_bwd"):
            return layer_gram_bwd(ctx.saved_tensors, g.to(torch.float32).contiguous())


def layer_gram(*taps: torch.Tensor) -> torch.Tensor:
    """Per-layer (Gatys) grams of L taps, each [1, T, C] -> [L, C, C]
    float32, ``G[l, a, b] = sum_t taps[l][0, t, a] * taps[l][0, t, b]``."""
    if taps[0].device.type == "cpu":
        return layer_gram_reference(*taps)
    return LayerGram.apply(*taps)
