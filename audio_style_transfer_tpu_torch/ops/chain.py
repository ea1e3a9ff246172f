"""Encoder trunk with hand-written CUDA kernels (counterpart of
audio_style_transfer_tpu/ops/pallas_chain.py).

The trunk is the stack of residual blocks
``x_{j+1} = x_j + relu(conv3_d(relu x_j) + b_d) @ W_res + b_res`` on
[T, 128] activations. Its forward (K1) runs one layer per launch and stashes
one mask byte per element (bit 0: x_{j+1} > 0, bit 1: the gate y_j > 0; the
first layer also writes the trunk input's relu mask). Its backward (K2)
computes the waveform cotangent from those masks alone, four matmuls per
layer, never reading an activation. K1 and K2 have two implementations,
chosen by the tensor's dtype: bfloat16 runs on the tensor cores
(csrc/trunk_mma.cu), float32 as float32 FMAs (csrc/trunk.cu). With
``_BWD_WAVEFRONT`` on (``AST_CHAIN_BWD_WAVEFRONT=1``; off by default, as in
the JAX package) runs of up to four layers with small dilations go through
one launch of the grouped wavefront backward (K2-wf, csrc/trunk_wf.cu),
which keeps the cotangents between those layers in shared memory; the other
layers keep K2.

Which version runs is decided by the device of the tensors: on the CPU each
wrapper runs its plain torch version (``layer_fwd_plain``/``layer_bwd_plain``,
same cast points as the kernel); on a CUDA tensor it launches the kernel or
raises. Weight gradients, when asked for, come from autograd through the
plain ``reference_trunk`` (a recompute, as the JAX custom VJP does).

``valid_window=(lo, hi)`` (plain Python ints, in-clip rows; JAX
``fused_trunk(valid_window=)``) re-zeroes every layer's output outside
[max(lo, 0), min(hi, clip_rows)): the forward is ``x_{j+1} = w * (x_j +
f(x_j))`` with the multiply before the output's mask bit is taken and the tap
is written, the backward masks ``g = w * (dxn + dtap)``. K1 and K2 take the
window as two ints (one predicate per row); ``None`` is the full range, which
the kernels and the plain versions compute bit for bit as before. K2-wf has
no windowed form (it is opt-in and slower than the K2 launches it replaces):
``trunk_backward`` refuses a window while ``_BWD_WAVEFRONT`` is on.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os

import torch

from audio_style_transfer_tpu_torch.ops import _build
from audio_style_transfer_tpu_torch.ops.conv import conv1d

WIDTH = 128  # the kernels' compiled channel count
_F32 = torch.float32
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)

# Run feasible groups of the trunk backward through K2-wf. Read at call time
# by ``trunk_backward``, so a test can set the attribute.
_BWD_WAVEFRONT = os.environ.get("AST_CHAIN_BWD_WAVEFRONT", "0") == "1"
# What csrc/trunk_wf.cu is compiled for: layers per group, the time tiles a
# block may own, the dy rows a piece may hold (its need + 15 <= WF_DY_ROWS),
# the bytes of the two warp groups' staging buffers, and what a block may use.
WF_MAX_LAYERS = 4
WF_TILES = (64, 32)
WF_DY_ROWS = 80
WF_STAGE_BYTES = 2 * 4 * (16 * 65 + 16 * 129 + WIDTH * (WF_DY_ROWS + 1))
SMEM_PER_BLOCK = 232448


def stack_trunk_weights(params, num_layers: int = 30):
    """[K,3,C,C] / [K,C] / [K,C,C] / [K,C] stacks of the ae_dilatedconv /
    ae_res weights."""
    layers = range(1, num_layers + 1)
    wd = torch.stack([params[f"ae_dilatedconv_{k}"]["w"] for k in layers])
    bd = torch.stack([params[f"ae_dilatedconv_{k}"]["b"] for k in layers])
    wr = torch.stack([params[f"ae_res_{k}"]["w"][0] for k in layers])
    br = torch.stack([params[f"ae_res_{k}"]["b"] for k in layers])
    return wd, bd, wr, br


def clamp_window(valid_window, clip_rows: int) -> tuple:
    """(lo, hi) clamped to the clip as the kernels take it; None is the full
    range. The window is host state: two Python ints."""
    if valid_window is None:
        return 0, clip_rows
    lo, hi = (int(v) for v in valid_window)
    return max(lo, 0), min(hi, clip_rows)


def window_rows(valid_window, rows: int, clip_rows: int, device):
    """[rows, 1] bool, True on the rows inside the window of their clip; None
    without a window."""
    if valid_window is None:
        return None
    lo, hi = clamp_window(valid_window, clip_rows)
    pos = torch.arange(rows, device=device) % clip_rows
    return ((pos >= lo) & (pos < hi))[:, None]


def _zero_outside(a, inside):
    return a if inside is None else torch.where(inside, a, torch.zeros_like(a))


def reference_trunk(x, wd, bd, wr, br, dils, emit, valid_window=None):
    """Unfused oracle through ops.conv (JAX ``reference_trunk``): the taps
    of ``emit`` in ascending order. x is [T, C] or [B, T, C]. With
    ``valid_window`` every layer's output is re-zeroed outside it."""
    squeeze = x.dim() == 2
    cur = x[None] if squeeze else x
    inside = window_rows(valid_window, cur.shape[1], cur.shape[1], cur.device)
    taps = {}
    for j, d in enumerate(dils):
        y = conv1d(torch.relu(cur), wd[j], bd[j], dilation=d, causal=False)
        cur = _zero_outside(cur + conv1d(torch.relu(y), wr[j][None], br[j]), inside)
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
                    want_inmask: bool = False, valid_window=None):
    """Plain version of K1 for one layer: (out, mask, inmask or None). The
    window zeroes ``out`` before its mask bit is taken."""
    y = dilated_conv_plain(x, wd, bd, d, clip_rows)
    out = _zero_outside(block_out_plain(x, y, wr, br),
                        window_rows(valid_window, x.shape[0], clip_rows, x.device))
    inmask = (x > 0).to(torch.uint8) if want_inmask else None
    return out, _masks(out, y), inmask


def layer_bwd_plain(dxn, dtap, mask, inmask, wd, wr, d: int, clip_rows: int,
                    valid_window=None):
    """Plain version of K2 for one layer: the cotangent of the layer input
    from the output cotangent ``dxn``, the emitted tap's cotangent ``dtap``
    (or None), this layer's mask bytes and the input's relu mask (bit 0).
    The window zeroes g = dxn + dtap (the emitted tap is the masked value)."""
    dt = dxn.dtype
    g = _zero_outside(dxn if dtap is None else dxn + dtap,
                      window_rows(valid_window, dxn.shape[0], clip_rows, dxn.device))
    dv = g.to(_F32) @ wr.to(_F32).T
    dy = (dv * ((mask >> 1) & 1).to(_F32)).to(dt).to(_F32)
    dr = transposed_conv_plain(dy, wd, d, clip_rows)
    return g + (dr * (inmask & 1).to(_F32)).to(dt)


@dataclasses.dataclass(frozen=True)
class BwdGroup:
    """Consecutive trunk layers [j0, j0 + len(dils)) of the backward. With
    ``splits`` (one per backward step) they run as one K2-wf launch on time
    tiles of ``tile`` rows; a single layer (``splits`` None) runs K2."""

    j0: int
    dils: tuple
    tile: int = 0
    splits: tuple | None = None


def _prefix(dils) -> tuple:
    n = [0]
    for d in dils:
        n.append(n[-1] + d)
    return tuple(n)


def wavefront_splits(dils: tuple, tile: int):
    """The A/B split of each backward step of a group, in carry coordinates,
    or None when the group cannot run as a wavefront.

    A block's carry holds ``tile`` rows and a halo of nk = sum(dils) rows each
    side; row nk is the tile's first. Step s (layer j = k-1-s, dilation d)
    produces dx_j on [nk - n_j, nk + tile + n_j), n_j = dils[0] + ... +
    dils[j-1]; piece A_s is the part left of split[s], B_s the rest. The last
    step splits the tile in half and every earlier split lies d_{s+1} further
    right, so that A_{s+1}, which reads d_{s+1} rows past its own output,
    reads only rows A_s wrote. A group is infeasible when a half would be
    empty, a piece's dy rows (its own plus d either side) leave the rows
    layer j+1 produced, or they do not fit the kernel's dy buffer."""
    k = len(dils)
    n = _prefix(dils)
    nk = n[-1]
    split = [0] * k
    split[k - 1] = nk + tile // 2
    for s in range(k - 2, -1, -1):
        split[s] = split[s + 1] + dils[k - 1 - (s + 1)]
    for s in range(k):
        j = k - 1 - s
        d = dils[j]
        lo, hi = nk - n[j], nk + tile + n[j]
        if not lo < split[s] < hi:
            return None
        if split[s] + d > nk + tile + n[j + 1] or split[s] - d < nk - n[j + 1]:
            return None
        if max(split[s] - lo, hi - split[s]) + 2 * d + 15 > WF_DY_ROWS:
            return None
    return tuple(split)


def wavefront_smem_bytes(dils: tuple, tile: int, itemsize: int) -> int:
    """Dynamic shared memory of one K2-wf block: the staging buffers and
    three carry slots of (tile + 2 nk) rows."""
    return WF_STAGE_BYTES + 3 * (tile + 2 * sum(dils)) * WIDTH * itemsize


@functools.lru_cache(maxsize=None)
def plan_bwd_groups(dils: tuple, clip_rows: int, itemsize: int) -> tuple:
    """Partition of the trunk's layers for the wavefront backward: from each
    layer on, the longest run of 2..WF_MAX_LAYERS layers that is feasible at
    the largest tile (``wavefront_splits``, the tile dividing the clip, the
    block's shared memory) becomes one group; a layer that starts no such
    run stays a single K2 launch."""
    groups, j = [], 0
    while j < len(dils):
        found = None
        for k in range(min(WF_MAX_LAYERS, len(dils) - j), 1, -1):
            run = tuple(dils[j:j + k])
            for tile in WF_TILES:
                if clip_rows % tile:
                    continue
                if wavefront_smem_bytes(run, tile, itemsize) > SMEM_PER_BLOCK:
                    continue
                splits = wavefront_splits(run, tile)
                if splits is not None:
                    found = BwdGroup(j, run, tile, splits)
                    break
            if found:
                break
        groups.append(found or BwdGroup(j, (dils[j],)))
        j += len(groups[-1].dils)
    return tuple(groups)


def _tile_windows(a: torch.Tensor, clip_rows: int, tile: int, halo: int) -> torch.Tensor:
    """[rows, C] -> [tiles, tile + 2 halo, C]: every time tile with ``halo``
    rows either side, zero outside the tile's clip."""
    c = a.shape[-1]
    clips = a.reshape(-1, clip_rows, c)
    zeros = clips.new_zeros(clips.shape[0], halo, c)
    padded = torch.cat([zeros, clips, zeros], dim=1)
    win = padded.unfold(1, tile + 2 * halo, tile)  # [clips, tiles, C, ext]
    return win.permute(0, 1, 3, 2).reshape(-1, tile + 2 * halo, c)


def group_bwd_chain_plain(dxn, dtaps, masks, inmask, wd, wr, dils, clip_rows: int):
    """The oracle of K2-wf: ``layer_bwd_plain`` layer by layer, last first."""
    dx = dxn
    for j in range(len(dils) - 1, -1, -1):
        dx = layer_bwd_plain(dx, dtaps[j], masks[j], masks[j - 1] if j else inmask,
                             wd[j], wr[j], dils[j], clip_rows)
    return dx


def group_bwd_plain(dxn, dtaps, masks, inmask, wd, wr, dils, clip_rows: int,
                    tile: int, splits):
    """Plain version of K2-wf with the kernel's own schedule: every tile with
    its halo in a three-slot carry, the pieces in the order A_0, A_1, B_0,
    A_2, B_1, ... B_{k-1}, each reading slot (s-1) % 3 and writing its rows
    of slot s % 3, with ``layer_bwd_plain``'s cast points. All tiles advance
    together as a leading dimension."""
    k, dt = len(dils), dxn.dtype
    n = _prefix(dils)
    nk = n[-1]
    windows = functools.partial(_tile_windows, clip_rows=clip_rows, tile=tile, halo=nk)
    carry = [None, None, windows(dxn)]
    carry[0], carry[1] = torch.zeros_like(carry[2]), torch.zeros_like(carry[2])
    dtap_w = [None if g is None else windows(g) for g in dtaps]
    mask_w = [windows(m) for m in masks]
    inmask_w = windows(inmask)

    def piece(s, lo, hi):
        j = k - 1 - s
        d, w = dils[j], hi - lo
        g = carry[(s - 1) % 3][:, lo - d:hi + d]
        if dtap_w[j] is not None:
            g = g + dtap_w[j][:, lo - d:hi + d]
        dv = g.to(_F32) @ wr[j].to(_F32).T
        gate = ((mask_w[j][:, lo - d:hi + d] >> 1) & 1).to(_F32)
        dy = (dv * gate).to(dt).to(_F32)
        dr = (dy[:, 2 * d:2 * d + w] @ wd[j][0].to(_F32).T
              + dy[:, d:d + w] @ wd[j][1].to(_F32).T
              + dy[:, :w] @ wd[j][2].to(_F32).T)
        inrelu = ((mask_w[j - 1] if j else inmask_w)[:, lo:hi] & 1).to(_F32)
        carry[s % 3][:, lo:hi] = g[:, d:d + w] + (dr * inrelu).to(dt)

    def piece_a(s):
        piece(s, nk - n[k - 1 - s], splits[s])

    def piece_b(s):
        piece(s, splits[s], nk + tile + n[k - 1 - s])

    piece_a(0)
    for s in range(1, k):
        piece_a(s)
        piece_b(s - 1)
    piece_b(k - 1)
    return carry[(k - 1) % 3][:, nk:nk + tile].reshape(dxn.shape)


def check_cuda(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be aligned to 16 bytes")


def check_layer(x, clip_rows):
    if x.device.type != "cuda":
        raise RuntimeError(f"trunk kernels run on CUDA tensors, got {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"trunk kernels take float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] != WIDTH:
        raise ValueError(f"trunk kernels take [rows, {WIDTH}], got {tuple(x.shape)}")
    if clip_rows <= 0 or x.shape[0] % clip_rows:
        raise ValueError(f"rows {x.shape[0]} must be a multiple of clip_rows {clip_rows}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_bf16(t):
    if t.dtype != torch.bfloat16:
        raise TypeError(f"the tensor-core kernels take bfloat16, got {t.dtype}")


def _layer_fwd_cuda(x, wd, bd, wr, br, d: int, clip_rows: int, want_inmask: bool, mma: bool,
                    valid_window=None):
    """Launch K1 on CUDA tensors: the tensor-core kernel (bfloat16 only) when
    ``mma``, else the float32-FMA kernel in x's dtype."""
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
    args = (x.data_ptr(), wd.data_ptr(), bd.data_ptr(), wr.data_ptr(), br.data_ptr(),
            out.data_ptr(), mask.data_ptr(), _ptr(inmask), x.shape[0], clip_rows, d,
            *clamp_window(valid_window, clip_rows))
    if mma:
        name = "ast_trunk_fwd_mma"
        status = _build.lib().ast_trunk_fwd_mma(*args, _build.stream_ptr(dev))
    else:
        name = "ast_trunk_fwd"
        status = _build.lib().ast_trunk_fwd(*args, int(dt == torch.bfloat16),
                                            _build.stream_ptr(dev))
    _build.check(status, name)
    _build.LAUNCHES["K1"] += 1
    return out, mask, inmask


def layer_fwd(x, wd, bd, wr, br, d: int, clip_rows: int, want_inmask: bool = False,
              valid_window=None):
    """One trunk layer forward: K1 on CUDA (bfloat16: the tensor-core kernel
    of csrc/trunk_mma.cu; float32: the FMA kernel of csrc/trunk.cu), the
    plain version on the CPU.

    x [rows, C] (rows = clips * clip_rows), wd [3, C, C], wr [C, C] in x's
    dtype; bd, br [C] float32; valid_window (lo, hi) in in-clip rows or None.
    Returns (out, mask, inmask or None)."""
    if x.device.type == "cpu":
        return layer_fwd_plain(x, wd, bd, wr, br, d, clip_rows, want_inmask, valid_window)
    return _layer_fwd_cuda(x, wd, bd, wr, br, d, clip_rows, want_inmask,
                           mma=x.dtype == torch.bfloat16, valid_window=valid_window)


def layer_fwd_fma(x, wd, bd, wr, br, d: int, clip_rows: int, want_inmask: bool = False,
                  valid_window=None):
    """K1's FMA kernel (csrc/trunk.cu) in x's dtype, bfloat16 included: the
    code K7f, K7b and K2-wf are built on. For comparisons only; no transfer
    path calls it."""
    return _layer_fwd_cuda(x, wd, bd, wr, br, d, clip_rows, want_inmask, mma=False,
                           valid_window=valid_window)


def _check_layer_bwd(dxn, dtap, mask, inmask, wd, wr, clip_rows: int):
    check_layer(dxn, clip_rows)
    c, dev, dt = WIDTH, dxn.device, dxn.dtype
    check_cuda("dxn", dxn, dxn.shape, dt, dev)
    if dtap is not None:
        check_cuda("dtap", dtap, dxn.shape, dt, dev)
    for name, m in (("mask", mask), ("inmask", inmask)):
        if m is not None:
            check_cuda(name, m, dxn.shape, torch.uint8, dev)
    if wd is not None:
        check_cuda("wd", wd, (3, c, c), dt, dev)
    if wr is not None:
        check_cuda("wr", wr, (c, c), dt, dev)


def _layer_bwd_cuda(dxn, dtap, mask, inmask, wd, wr, d: int, clip_rows: int, mma: bool,
                    valid_window=None):
    """Launch K2 (both phases) on CUDA tensors; ``mma`` as in ``_layer_fwd_cuda``."""
    _check_layer_bwd(dxn, dtap, mask, inmask, wd, wr, clip_rows)
    dev = dxn.device
    dy = torch.empty_like(dxn)
    dx = torch.empty_like(dxn)
    args = (dxn.data_ptr(), _ptr(dtap), mask.data_ptr(), inmask.data_ptr(), wd.data_ptr(),
            wr.data_ptr(), dy.data_ptr(), dx.data_ptr(), dxn.shape[0], clip_rows, d,
            *clamp_window(valid_window, clip_rows))
    if mma:
        name = "ast_trunk_bwd_mma"
        status = _build.lib().ast_trunk_bwd_mma(*args, _build.stream_ptr(dev))
    else:
        name = "ast_trunk_bwd"
        status = _build.lib().ast_trunk_bwd(*args, int(dxn.dtype == torch.bfloat16),
                                            _build.stream_ptr(dev))
    _build.check(status, name)
    _build.LAUNCHES["K2"] += 1
    return dx


def layer_bwd(dxn, dtap, mask, inmask, wd, wr, d: int, clip_rows: int, valid_window=None):
    """One trunk layer backward: K2 on CUDA (bfloat16: csrc/trunk_mma.cu;
    float32: csrc/trunk.cu), the plain version on the CPU."""
    if dxn.device.type == "cpu":
        return layer_bwd_plain(dxn, dtap, mask, inmask, wd, wr, d, clip_rows, valid_window)
    return _layer_bwd_cuda(dxn, dtap, mask, inmask, wd, wr, d, clip_rows,
                           mma=dxn.dtype == torch.bfloat16, valid_window=valid_window)


def layer_bwd_fma(dxn, dtap, mask, inmask, wd, wr, d: int, clip_rows: int, valid_window=None):
    """K2's FMA kernels (csrc/trunk.cu) in dxn's dtype, bfloat16 included: the
    launches K2-wf equals bit for bit. For comparisons only; no transfer path
    calls it."""
    return _layer_bwd_cuda(dxn, dtap, mask, inmask, wd, wr, d, clip_rows, mma=False,
                           valid_window=valid_window)


def layer_bwd_mma_phase1(dxn, dtap, mask, wr, clip_rows: int, valid_window=None):
    """Phase 1 of the bfloat16 K2 alone (for timing it): dy. Not counted as a
    K2 launch."""
    _check_bf16(dxn)
    _check_layer_bwd(dxn, dtap, mask, None, None, wr, clip_rows)
    dy = torch.empty_like(dxn)
    status = _build.lib().ast_trunk_bwd_dy_mma(
        dxn.data_ptr(), _ptr(dtap), mask.data_ptr(), wr.data_ptr(), dy.data_ptr(),
        dxn.shape[0], clip_rows, *clamp_window(valid_window, clip_rows),
        _build.stream_ptr(dxn.device))
    _build.check(status, "ast_trunk_bwd_dy_mma")
    return dy


def layer_bwd_mma_phase2(dxn, dtap, dy, inmask, wd, d: int, clip_rows: int, valid_window=None):
    """Phase 2 of the bfloat16 K2 alone (for timing it): dx from phase 1's dy.
    Not counted as a K2 launch."""
    _check_bf16(dxn)
    _check_layer_bwd(dxn, dtap, None, inmask, wd, None, clip_rows)
    check_cuda("dy", dy, dxn.shape, dxn.dtype, dxn.device)
    dx = torch.empty_like(dxn)
    status = _build.lib().ast_trunk_bwd_dx_mma(
        dxn.data_ptr(), _ptr(dtap), dy.data_ptr(), inmask.data_ptr(), wd.data_ptr(),
        dx.data_ptr(), dxn.shape[0], clip_rows, d, *clamp_window(valid_window, clip_rows),
        _build.stream_ptr(dxn.device))
    _build.check(status, "ast_trunk_bwd_dx_mma")
    return dx


def product_mma(a, w, transposed: bool):
    """a [rows, C] @ w [C, C] (or w^T) in float32 from bfloat16 CUDA tensors,
    through the staging and fragment code of csrc/trunk_mma.cu: one product
    of the tensor-core kernels alone, for testing them."""
    check_layer(a, a.shape[0])
    _check_bf16(a)
    check_cuda("a", a, a.shape, torch.bfloat16, a.device)
    check_cuda("w", w, (WIDTH, WIDTH), torch.bfloat16, a.device)
    out = torch.empty(a.shape, dtype=_F32, device=a.device)
    status = _build.lib().ast_product_mma(a.data_ptr(), w.data_ptr(), out.data_ptr(),
                                          a.shape[0], int(transposed),
                                          _build.stream_ptr(a.device))
    _build.check(status, "ast_product_mma")
    return out


def group_bwd(dxn, dtaps, masks, inmask, wd, wr, group: BwdGroup, clip_rows: int):
    """The cotangent of a wavefront group's input from ``dxn``, the cotangent
    of its output: K2-wf on CUDA, ``group_bwd_plain`` on the CPU.

    dtaps: per layer of the group the emitted tap's cotangent or None; masks:
    per layer its mask bytes; inmask: bit 0 is the group input's relu mask;
    wd [k, 3, C, C], wr [k, C, C] of the group in dxn's dtype."""
    dils, k = group.dils, len(group.dils)
    if group.splits is None or len(dtaps) != k or len(masks) != k:
        raise ValueError(f"group_bwd needs a planned group of {k} layers with their "
                         f"tap cotangents and masks, got {group}")
    if dxn.device.type == "cpu":
        return group_bwd_plain(dxn, dtaps, masks, inmask, wd, wr, dils, clip_rows,
                               group.tile, group.splits)
    check_layer(dxn, clip_rows)
    c, dev, dt = WIDTH, dxn.device, dxn.dtype
    if clip_rows % group.tile:
        raise ValueError(f"clip_rows {clip_rows} must be a multiple of the tile {group.tile}")
    if wavefront_smem_bytes(dils, group.tile, dxn.element_size()) > SMEM_PER_BLOCK:
        raise ValueError(f"group {group} does not fit a block's shared memory in {dt}")
    check_cuda("dxn", dxn, dxn.shape, dt, dev)
    for g in dtaps:
        if g is not None:
            check_cuda("dtap", g, dxn.shape, dt, dev)
    for m in (*masks, inmask):
        check_cuda("mask", m, dxn.shape, torch.uint8, dev)
    check_cuda("wd", wd, (k, 3, c, c), dt, dev)
    check_cuda("wr", wr, (k, c, c), dt, dev)
    dx = torch.empty_like(dxn)
    status = _build.lib().ast_trunk_bwd_group(
        dxn.data_ptr(),
        (ctypes.c_void_p * k)(*[None if g is None else g.data_ptr() for g in dtaps]),
        (ctypes.c_void_p * k)(*[m.data_ptr() for m in masks]),
        inmask.data_ptr(), wd.data_ptr(), wr.data_ptr(), dx.data_ptr(),
        (ctypes.c_int * k)(*dils), (ctypes.c_int * k)(*group.splits), k, group.tile,
        dxn.shape[0], clip_rows, int(dt == torch.bfloat16), _build.stream_ptr(dev))
    _build.check(status, "ast_trunk_bwd_group")
    _build.LAUNCHES["K2wf"] += 1
    return dx


def trunk_forward(x2d, wd, bd, wr, br, dils, clip_rows: int, valid_window=None):
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
                               want_inmask=(j == 0), valid_window=valid_window)
        if j == 0:
            inmask = im
        outs.append(cur)
        masks.append(m)
    return outs, masks, inmask


def trunk_backward(dtaps: dict, masks, inmask, wd, wr, dils, clip_rows: int,
                   valid_window=None):
    """Waveform cotangent of the trunk input from tap cotangents
    ({layer: [rows, C] or None}); the last layer's seeds the chain. With
    ``_BWD_WAVEFRONT`` on, the groups of ``plan_bwd_groups`` run through
    ``group_bwd`` and the remaining layers through ``layer_bwd``; K2-wf has no
    windowed form, so that setting with a window raises."""
    if _BWD_WAVEFRONT and valid_window is not None:
        raise NotImplementedError(
            "the grouped wavefront backward (K2-wf) has no valid-window form: switch "
            "_BWD_WAVEFRONT / AST_CHAIN_BWD_WAVEFRONT off for a windowed trunk")
    last = len(dils) - 1
    seed = dtaps.get(last)
    if seed is None:
        raise ValueError("trunk_backward needs the last tap's cotangent")
    dt = seed.dtype
    wd, wr = wd.to(dt).contiguous(), wr.to(dt).contiguous()
    if _BWD_WAVEFRONT:
        groups = plan_bwd_groups(tuple(dils), clip_rows, seed.element_size())
    else:
        groups = tuple(BwdGroup(j, (d,)) for j, d in enumerate(dils))
    dx = seed
    for group in reversed(groups):
        j0, k = group.j0, len(group.dils)
        in_m = masks[j0 - 1] if j0 > 0 else inmask
        taps = [dtaps.get(j) if j != last else None for j in range(j0, j0 + k)]
        if group.splits is None:
            dx = layer_bwd(dx, taps[0], masks[j0], in_m, wd[j0], wr[j0], dils[j0], clip_rows,
                           valid_window)
        else:
            dx = group_bwd(dx, taps, masks[j0:j0 + k], in_m, wd[j0:j0 + k], wr[j0:j0 + k],
                           group, clip_rows)
    return dx


class TrunkFunction(torch.autograd.Function):
    """Whole-trunk op: x [B, T, C] -> the taps of ``emit`` (ascending,
    including the last layer). Forward through K1, waveform gradient
    through K2; weight gradients by recompute through ``reference_trunk``
    only when asked for."""

    @staticmethod
    def forward(ctx, x, wd, bd, wr, br, dils, emit, valid_window=None):
        b, t, c = x.shape
        outs, masks, inmask = trunk_forward(
            x.reshape(b * t, c).contiguous(), wd, bd, wr, br, dils, t, valid_window)
        ctx.save_for_backward(x, wd, bd, wr, br, inmask, *masks)
        ctx.dils, ctx.emit, ctx.valid_window = dils, emit, valid_window
        ctx.set_materialize_grads(False)
        return tuple(outs[j].view(b, t, c) for j in emit)

    @staticmethod
    def backward(ctx, *dtaps):
        x, wd, bd, wr, br, inmask, *masks = ctx.saved_tensors
        dils, emit, valid_window = ctx.dils, ctx.emit, ctx.valid_window
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
            dx = trunk_backward(flat, masks, inmask, wd, wr, dils, t,
                                valid_window).view(b, t, c)
        if any(ctx.needs_input_grad[1:5]):
            with torch.enable_grad():
                ws = [w.detach().requires_grad_(True) for w in (wd, bd, wr, br)]
                taps = reference_trunk(x.detach(), *ws, dils, emit, valid_window)
                pairs = [(tp, g) for tp, g in zip(taps, dtaps) if g is not None]
                dwd, dbd, dwr, dbr = torch.autograd.grad(
                    [p[0] for p in pairs], ws, [p[1] for p in pairs],
                    allow_unused=True)
        return dx, dwd, dbd, dwr, dbr, None, None, None


def fused_trunk(x, wd, bd, wr, br, dils, emit, valid_window=None):
    """The trunk's taps of ``emit`` (the last layer is always added), in
    ascending layer order. x is [B, T, C] or [T, C].

    ``valid_window``: (lo, hi) Python ints; every layer's output is re-zeroed
    outside [lo, hi) (the halo windows of the exact long-form scan). The
    window is one clip's state: batch 1 only, as in the JAX package."""
    dils = tuple(int(d) for d in dils)
    emit = tuple(sorted(set(int(e) for e in emit) | {len(dils) - 1}))
    if valid_window is not None:
        if x.dim() == 3 and x.shape[0] != 1:
            raise ValueError(
                f"fused_trunk: a valid window is one clip's state, got batch {x.shape[0]}")
        valid_window = (int(valid_window[0]), int(valid_window[1]))
    if x.dim() == 2:
        return tuple(tp[0] for tp in TrunkFunction.apply(x[None], wd, bd, wr, br, dils, emit,
                                                         valid_window))
    return TrunkFunction.apply(x, wd, bd, wr, br, dils, emit, valid_window)
