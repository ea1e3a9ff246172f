"""Exact full-sequence transfer loss, over several ranks or on one device
(counterpart of audio_style_transfer_tpu/parallel/halo.py).

The reference scales long audio by chunking with gram averaging, which
changes semantics at chunk borders. Exact mode keeps ONE global gram over the
whole clip, exact content features at every sample and SAME padding only at
the clip's ends.

Over the ranks of a mesh axis (time sharding), each rank holds a contiguous
chunk of the clip:
  1. one halo exchange (``parallel.mesh.neighbour_exchange``) gives every
     rank the encoder's receptive field from both neighbours, rounded up to
     a multiple of 512 (3072 at full width);
  2. every rank runs the trunk on its halo-extended chunk with a valid
     window on the first and the last rank (the clip's SAME padding), and
     crops the halo off its taps;
  3. grams are time sums, so the global gram is the sum of the ranks'
     partial grams (``parallel.mesh.psum``); the content term is the mean of
     the ranks' means and the STFT regularizer a sum over frames, each one
     all-reduce. Content features stay sharded.
Every rank computes the same loss. The all-reduces' backward is the
identity: each rank backpropagates that replicated loss, so the cotangent it
receives is already the whole one. The exchange's backward sends each halo's
cotangent back to the rank it came from.

Every flavour's loss is ``transfer/losses.py::weighted_loss`` of its own
content mean and float32 gram sums (``content_of``, ``gram_sums_of``,
``style_of``), as the clip path's ``transfer_loss`` is. The single-device
flavours live here, not in ``transfer/``, because the benchmark's calibration
(``portbench/calibrate.py``) replaces ``make_scan_exact_value_and_grad_fn`` in
this module.

On one device two flavours compute the same loss:

  - single window (``_single_window_exact_loss_fn``): one unmasked trunk pass
    at T = the clip. The trunk's own clip-edge padding is the global one, so
    there is no halo, no masking and no cropping. Live memory is the whole
    clip's taps and mask bytes.
  - window scan (``make_scan_exact_loss_fn``): fixed windows, each extended by
    the encoder's receptive-field radius on both sides and run through the
    trunk with a valid window (``encoder_trunk(valid_window=)``, the windowed
    K1/K2), the taps cropped back to the window. Grams are time sums and the
    content term a mean over T, so per-window partial sums give the global
    loss (float32 sums in another order). Windows whose extended tile lies
    inside the clip run unmasked; the edge windows, and a zero-padded tail
    (``t_valid < t_total``), run masked with static (lo, hi).

The JAX scan remats each middle window (``jax.checkpoint``) so that live
memory is one window's. The eager counterpart is
``make_scan_exact_value_and_grad_fn``: pass 1 sums the windows' content
squares, partial grams and STFT sums without a graph; the loss and the
cotangents of the three sums follow from the totals; pass 2 recomputes each
window with autograd on and backpropagates against those cotangents into the
window's slice of the gradient (overlapping halos accumulate).
``make_scan_exact_loss_fn`` returns the plain differentiable loss, which holds
every window's graph: the oracle of the two-pass function, and fine for short
clips.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from audio_style_transfer_tpu_torch.models.wavenet_ae import (
    WaveNetAEConfig,
    encoder_trunk,
    receptive_field_radius,
)
from audio_style_transfer_tpu_torch.parallel.mesh import neighbour_exchange, psum
from audio_style_transfer_tpu_torch.signal.mu_law import inv_mu_law, safe_abs
from audio_style_transfer_tpu_torch.signal.stft import stft
from audio_style_transfer_tpu_torch.transfer.losses import (
    FRAME_LENGTH,
    FRAME_STEP,
    LossSpec,
    content_of,
    gram_sums_of,
    mean_square,
    needed_taps,
    stft_regularizer,
    style_of,
    weighted_loss,
)

_F32 = torch.float32


def _window_radius(cfg: WaveNetAEConfig, align: int = 512) -> int:
    """The receptive-field radius rounded up to a multiple of ``align`` (extra
    halo rows are recomputed and cropped, so the rounding changes nothing)."""
    return -(-receptive_field_radius(cfg) // align) * align


def _exchange_halos(x_local, radius: int, group):
    """[B, chunk] -> [B, chunk + 2 radius]: ``radius`` samples of each
    neighbour on either side of the rank's chunk; zeros past the clip's
    ends (the single-device encoder's zero padding)."""
    if x_local.shape[-1] < radius:
        raise ValueError(f"a chunk of {x_local.shape[-1]} samples is shorter than the halo "
                         f"{radius}: the exchange reaches only the next rank")
    left_halo, right_halo = neighbour_exchange(group, x_local[:, :radius], x_local[:, -radius:])
    return torch.cat([left_halo, x_local, right_halo], dim=1)


def time_sharded_trunk(params, x_local, cfg: WaveNetAEConfig, group, needed_taps=None):
    """The rank's taps of the whole clip's encoder trunk, cropped to its
    chunk ``x_local`` [1, chunk] (entries the caller did not list in
    ``needed_taps`` may be None, as in ``encoder_trunk``).

    The valid window comes from the rank's index: the first rank's halo lies
    before the clip (lo = radius), the last rank's after it (hi = chunk +
    radius); ranks in between see only clip samples and run unwindowed, the
    same as their full window (0, chunk + 2 radius). Every rank of ``group``
    must call it together."""
    radius = _window_radius(cfg)
    x_ext = _exchange_halos(x_local, radius, group)
    idx, n = dist.get_rank(group), dist.get_world_size(group)
    chunk = x_local.shape[1]
    window = (radius if idx == 0 else 0,
              chunk + radius if idx == n - 1 else chunk + 2 * radius)
    if window == (0, chunk + 2 * radius):
        window = None
    extracts = encoder_trunk(params, x_ext, cfg, needed_taps=needed_taps, valid_window=window)
    return [None if e is None else e[:, radius:-radius, :] for e in extracts]


def sharded_stft_l1(a_local, group, frame_length: int = FRAME_LENGTH,
                    frame_step: int = FRAME_STEP):
    """The global ``stft_l1`` of a time-sharded signal ``a_local`` [chunk]
    (audio domain), equal on every rank. Each rank takes frame_length -
    frame_step samples of its right neighbour, so a frame across a chunk
    border is computed once, by the rank it starts on; frames past the
    clip's end are masked off. Needs chunk % frame_step == 0."""
    idx, n = dist.get_rank(group), dist.get_world_size(group)
    chunk = a_local.shape[-1]
    if chunk % frame_step:
        raise ValueError(
            f"sharded_stft_l1 needs chunk % frame_step == 0, got {chunk} % {frame_step}")
    _, right_halo = neighbour_exchange(group, a_local[..., :frame_length - frame_step], None)
    s = stft(torch.cat([a_local, right_halo], dim=-1), frame_length, frame_step)
    m = s.shape[-2]
    n_global = 1 + (n * chunk - frame_length) // frame_step
    in_range = (idx * m + torch.arange(m, device=a_local.device)) < n_global
    vals = safe_abs(s.real) + safe_abs(s.imag)
    total = psum(torch.sum(vals * in_range.to(vals.dtype)[..., :, None]), group)
    return total / (n_global * s.shape[-1])


def make_sharded_embeds_fn(cfg: WaveNetAEConfig, spec: LossSpec, mesh,
                           axis_name: str = "time"):
    """(params, x_local [1, chunk]) -> (the rank's content embed [chunk, C*],
    the whole clip's normalized style gram, equal on every rank): the
    target-building companion of ``make_sharded_loss_fn``, one trunk pass."""
    group = mesh.get_group(axis_name)
    needed = needed_taps(spec)

    def embeds(params, x_local):
        extracts = time_sharded_trunk(params, x_local, cfg, group, needed_taps=needed)
        return content_of(extracts, spec), style_of(psum(gram_sums_of(extracts, spec), group),
                                                    spec)

    return embeds


def make_sharded_embeds(params, cfg: WaveNetAEConfig, spec: LossSpec, mesh,
                        axis_name: str = "time"):
    """``make_sharded_embeds_fn`` with the weights bound: x_local -> (content
    embed, gram)."""
    embeds = make_sharded_embeds_fn(cfg, spec, mesh, axis_name)
    return lambda x_local: embeds(params, x_local)


def make_sharded_loss_fn(cfg: WaveNetAEConfig, spec: LossSpec, mesh, axis_name: str = "time"):
    """(params, x_local [1, chunk], phi_c_local [chunk, C*], phi_s) -> the
    whole clip's transfer loss, equal on every rank of the mesh axis: the
    rank's chunk of the waveform and of the content target, the style target
    replicated. Differentiable in ``x_local``: its gradient is the rank's
    chunk of the whole clip's. Chunks must be of one length on every rank."""
    group = mesh.get_group(axis_name)
    n = mesh.size(mesh.mesh_dim_names.index(axis_name))
    needed = needed_taps(spec)

    def loss(params, x_local, phi_c_local, phi_s):
        extracts = time_sharded_trunk(params, x_local, cfg, group, needed_taps=needed)
        content = psum(mean_square(content_of(extracts, spec), phi_c_local), group) / n
        gram = style_of(psum(gram_sums_of(extracts, spec), group), spec)
        return weighted_loss(spec, content, gram, phi_s,
                             lambda: sharded_stft_l1(inv_mu_law(x_local[0]), group))[0]

    return loss


def make_sharded_loss(params, phi_c_local, phi_s, cfg: WaveNetAEConfig, spec: LossSpec, mesh,
                      axis_name: str = "time"):
    """``make_sharded_loss_fn`` with weights and targets bound: x_local ->
    loss."""
    loss = make_sharded_loss_fn(cfg, spec, mesh, axis_name)
    return lambda x_local: loss(params, x_local, phi_c_local, phi_s)


def _single_window_exact_loss_fn(cfg: WaveNetAEConfig, spec: LossSpec, t_total: int):
    """Whole-clip exact loss as one unmasked trunk pass:
    (params, x [1, t_total], phi_c, phi_s) -> scalar."""
    needed = needed_taps(spec)

    def loss(params, x, phi_c, phi_s):
        extracts = encoder_trunk(params, x, cfg, needed_taps=needed)
        content = mean_square(content_of(extracts, spec), phi_c)
        gram = style_of(gram_sums_of(extracts, spec), spec)
        return weighted_loss(spec, content, gram, phi_s, lambda: stft_regularizer(x))[0]

    return loss


def _single_window_exact_embeds_fn(cfg: WaveNetAEConfig, spec: LossSpec):
    needed = needed_taps(spec)

    def embeds(params, x):
        extracts = encoder_trunk(params, x, cfg, needed_taps=needed)
        return content_of(extracts, spec), style_of(gram_sums_of(extracts, spec), spec)

    return embeds


class _Scan:
    """Geometry and per-window terms of the window scan."""

    def __init__(self, cfg, spec, t_total: int, window: int, t_valid: int):
        if t_total % window or window % FRAME_STEP:
            raise ValueError(
                f"t_total {t_total} must tile into 512-aligned windows of {window}")
        self.cfg, self.spec = cfg, spec
        self.t_total, self.window, self.t_valid = t_total, window, t_valid
        self.radius = _window_radius(cfg, align=2048)
        self.n_win = t_total // window
        self.w_ext = window + 2 * self.radius
        self.needed = needed_taps(spec)
        self.n_frames = 1 + (t_valid - FRAME_LENGTH) // FRAME_STEP
        self.m_win = window // FRAME_STEP
        # A window is fully valid iff its extended tile lies inside
        # [0, t_valid): those run the unmasked trunk. mid_lo..mid_hi is that
        # contiguous range; when it is empty every window runs masked.
        mid_lo = -(-self.radius // window)
        mid_hi = (t_valid - self.radius) // window - 1
        self.split = mid_lo <= mid_hi and self.n_win >= 2
        if self.split:
            self.edge = [*range(mid_lo), *range(mid_hi + 1, self.n_win)]
            self.middle = list(range(mid_lo, mid_hi + 1))
        else:
            self.edge, self.middle = list(range(self.n_win)), []

    def order(self):
        """(window index, masked?) in the order the sums are taken."""
        return [(i, True) for i in self.edge] + [(i, False) for i in self.middle]

    def valid_window(self, i: int) -> tuple:
        """Position p of window i's extended tile is global sample
        i * window - radius + p, valid iff it lies in [0, t_valid)."""
        return (max(0, self.radius - i * self.window),
                min(self.w_ext, self.t_valid - i * self.window + self.radius))

    def prepare(self, x):
        """x [1, t_total] with the pad tail zeroed (the start conv reads raw
        x, so positions near t_valid must see the zeros a t_valid-long clip's
        padding gives; the multiply also makes the tail's gradient zero), and
        zero-padded by the radius both sides."""
        if self.t_valid < self.t_total:
            keep = torch.arange(self.t_total, device=x.device) < self.t_valid
            x = x * keep.to(x.dtype)[None]
        return torch.nn.functional.pad(x, (self.radius, self.radius))

    def trunk_terms(self, params, x_ext, vw):
        """(cropped content embed [window, C*], partial gram) of one window."""
        extracts = encoder_trunk(params, x_ext, self.cfg, needed_taps=self.needed,
                                 valid_window=vw)
        r = self.radius
        extracts = [None if e is None else e[:, r:-r, :] for e in extracts]
        return content_of(extracts, self.spec), gram_sums_of(extracts, self.spec)

    def reg_sum(self, x_ext, i: int):
        """Window i's share of the global non-centred STFT L1: the frames
        that start inside it, read with one frame of right halo from the
        neighbour's samples; frames past the global end are masked."""
        r = self.radius
        a = inv_mu_law(x_ext[0, r:r + self.window + FRAME_LENGTH - FRAME_STEP])
        s = stft(a, FRAME_LENGTH, FRAME_STEP)
        frames = i * self.m_win + torch.arange(self.m_win, device=a.device)
        vals = safe_abs(s.real) + safe_abs(s.imag)
        return torch.sum(vals * (frames < self.n_frames).to(vals.dtype)[:, None])

    def window_sums(self, params, x_ext, phi_c, i: int, masked: bool):
        """(content squares, partial gram, STFT sum) of window i from its
        extended tile x_ext [1, w_ext]."""
        c_local, gram_part = self.trunk_terms(
            params, x_ext, self.valid_window(i) if masked else None)
        pc = phi_c[i * self.window:(i + 1) * self.window]
        content_sq = torch.sum(torch.square(c_local.to(_F32) - pc))
        if self.spec.gamma != 0.0:
            reg = self.reg_sum(x_ext, i)
        else:
            reg = torch.zeros((), dtype=_F32, device=x_ext.device)
        return content_sq, gram_part, reg

    def x_ext(self, xp, i: int):
        return xp[:, i * self.window:i * self.window + self.w_ext]

    def sums(self, params, xp, phi_c):
        """The three global sums over all windows, in ``order()``."""
        total = None
        for i, masked in self.order():
            terms = self.window_sums(params, self.x_ext(xp, i), phi_c, i, masked)
            total = terms if total is None else tuple(a + b for a, b in zip(total, terms))
        return total

    def finish(self, csum, gsum, rsum, cdim: int, phi_s):
        """The loss from the three global sums."""
        return weighted_loss(self.spec, csum / (self.t_valid * cdim), style_of(gsum, self.spec),
                             phi_s, lambda: rsum / (self.n_frames * (FRAME_LENGTH // 2 + 1)))[0]


def _scan_or_none(cfg, spec, t_total: int, window: int, t_valid):
    """The scan's geometry, or None when one window spans the clip."""
    t_valid = t_total if t_valid is None else t_valid
    if not 0 < t_valid <= t_total:
        raise ValueError(f"t_valid {t_valid} outside (0, {t_total}]")
    if window >= t_total:
        if t_valid != t_total:
            raise ValueError("single-window mode has no pad masking: trim to t_total")
        return None
    scan = _Scan(cfg, spec, t_total, window, t_valid)
    if spec.gamma != 0.0 and scan.n_frames < 1:
        # With t_valid < one frame the regularizer's mean would divide by zero.
        raise ValueError(f"t_valid {t_valid} is shorter than one STFT frame "
                         f"({FRAME_LENGTH}); the gamma regularizer is undefined")
    return scan


def make_scan_exact_loss_fn(cfg: WaveNetAEConfig, spec: LossSpec, t_total: int,
                            window: int = 32768, t_valid: int | None = None):
    """Exact long-form loss as a scan over ``window``-sample tiles:
    (params, x [1, t_total], phi_c [t_total, C*], phi_s) -> scalar, plainly
    differentiable (every window's graph is held until the backward).

    ``t_total`` must be a multiple of ``window`` and ``window`` of 512, so the
    STFT frames partition cleanly. ``t_valid`` (default ``t_total``) is the
    true clip length when the caller zero-padded the clip up to whole
    windows: positions in [t_valid, t_total) are zeroed before the trunk,
    masked out of every tap, and left out of the content mean and the STFT
    frame count, so loss and gradient equal the unpadded computation.
    ``window >= t_total`` returns the single-window loss."""
    scan = _scan_or_none(cfg, spec, t_total, window, t_valid)
    if scan is None:
        return _single_window_exact_loss_fn(cfg, spec, t_total)

    def loss(params, x, phi_c, phi_s):
        phi_c = phi_c.to(_F32)
        return scan.finish(*scan.sums(params, scan.prepare(x), phi_c), phi_c.shape[-1], phi_s)

    return loss


def make_scan_exact_value_and_grad_fn(cfg: WaveNetAEConfig, spec: LossSpec, t_total: int,
                                      window: int = 32768, t_valid: int | None = None):
    """(params, x [1, t_total], phi_c, phi_s) -> (loss, dloss/dx [1, t_total])
    of ``make_scan_exact_loss_fn``'s loss, in two passes so that live memory
    is one window's (see the module docstring). ``window >= t_total``: one
    plain autograd pass over the single-window loss."""
    scan = _scan_or_none(cfg, spec, t_total, window, t_valid)
    if scan is None:
        single = _single_window_exact_loss_fn(cfg, spec, t_total)

        def value_and_grad_single(params, x, phi_c, phi_s):
            xv = x.detach().requires_grad_(True)
            loss = single(params, xv, phi_c, phi_s)
            (g,) = torch.autograd.grad(loss, xv)
            return loss.detach(), g

        return value_and_grad_single

    def value_and_grad(params, x, phi_c, phi_s):
        x = x.detach()
        phi_c = phi_c.to(_F32)
        xp = scan.prepare(x)
        # Pass 1: the three global sums, no graph.
        with torch.no_grad():
            sums = scan.sums(params, xp, phi_c)
        # The loss from the totals, and the cotangent of each sum.
        sums = [s.requires_grad_(True) for s in sums]
        loss = scan.finish(*sums, phi_c.shape[-1], phi_s)
        dc, dg, dr = torch.autograd.grad(loss, sums, allow_unused=True)
        # Pass 2: each window again with a graph, pulled back against those
        # cotangents into its slice of the padded gradient.
        gp_full = torch.zeros_like(xp)
        for i, masked in scan.order():
            xw = scan.x_ext(xp, i).detach().requires_grad_(True)
            c2, gp, r = scan.window_sums(params, xw, phi_c, i, masked)
            pulled = dc * c2 + torch.sum(dg * gp)
            if dr is not None:
                pulled = pulled + dr * r
            (gw,) = torch.autograd.grad(pulled, xw)
            gp_full[:, i * scan.window:i * scan.window + scan.w_ext] += gw
        grad = gp_full[:, scan.radius:scan.radius + t_total]
        if scan.t_valid < t_total:
            keep = torch.arange(t_total, device=x.device) < scan.t_valid
            grad = grad * keep.to(grad.dtype)[None]
        return loss.detach(), grad

    return value_and_grad


def make_scan_exact_embeds_fn(cfg: WaveNetAEConfig, spec: LossSpec, t_total: int,
                              window: int = 32768, t_valid: int | None = None):
    """Target-building companion of ``make_scan_exact_loss_fn``:
    (params, x [1, t_total]) -> (content embed [t_total, C*], gram) with exact
    full-sequence semantics, one window at a time. Positions past ``t_valid``
    are clip padding (the content embed is zero there). Runs once per clip,
    so every window takes the masked trunk."""
    scan = _scan_or_none(cfg, spec, t_total, window, t_valid)
    if scan is None:
        return _single_window_exact_embeds_fn(cfg, spec)

    def embeds(params, x):
        xp = scan.prepare(x)
        gsum, cs = None, []
        for i in range(scan.n_win):
            c_local, gp = scan.trunk_terms(params, scan.x_ext(xp, i), scan.valid_window(i))
            gsum = gp if gsum is None else gsum + gp
            cs.append(c_local)
        return torch.cat(cs, dim=0), style_of(gsum, spec)

    return embeds
