"""Long-form (60 s+) style transfer by chunking (counterpart of
audio_style_transfer_tpu/transfer/longform.py, chunked mode).

The waveform is split into batch_size windows; every window gets its own
content target and a shared (chunk-averaged, gram-translated) style target,
and the windows run one after another through the engine's single-clip
optimizer (``optimize_batch``), then are stitched with a short crossfade.

Optionally the style target is first mapped through the NMF + optimal
transport palette transform (reference utils.py:132-145), the "OT loss"
flavour of BASELINE.json config 5.

Exact mode (``transfer_exact``) optimizes ONE window spanning the whole
clip with one global gram, on one device: as a single unmasked trunk pass, or
as a scan over halo-extended windows (parallel/halo.py). Its mesh form waits
for the multi-device slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from audio_style_transfer_tpu_torch.analysis.nmf import nmf, nmf_transform
from audio_style_transfer_tpu_torch.analysis.ot import ot_admm, transform_palette
from audio_style_transfer_tpu_torch.models.wavenet_ae import encoder_extracts
from audio_style_transfer_tpu_torch.signal.mu_law import inv_mu_law_numpy, mu_law_numpy
from audio_style_transfer_tpu_torch.transfer.engine import StyleTransfer
from audio_style_transfer_tpu_torch.transfer.grams import l2_normalize, style_gram
from audio_style_transfer_tpu_torch.transfer.losses import transfer_embeds


@torch.no_grad()
def _window_targets(params, wins_q, pt, ps, cfg, lspec):
    """Per-window (content embed [K, T, C], translated style gram [K, ...]),
    left on the windows' device."""
    cs, grams = [], []
    for xq in wins_q:
        c, s = transfer_embeds(params, xq[None], cfg, lspec)
        cs.append(c)
        grams.append(l2_normalize(s + pt - ps, axes=(1, 2)))
    return torch.stack(cs), torch.stack(grams)


def chunk_audio(audio: np.ndarray, window: int) -> np.ndarray:
    """[T] -> [n_windows, window], dropping the trailing partial window."""
    n = len(audio) // window
    return audio[: n * window].reshape(n, window)


@dataclasses.dataclass
class LongformResult:
    audio: np.ndarray  # [total] stitched transferred waveform
    per_window: dict


def transfer_longform(
    engine: StyleTransfer,
    content_audio: np.ndarray,
    style_audio: np.ndarray,
    epochs: int | None = None,
    max_style_examples: int = 5,
    ot_components: int | None = None,
    ot_blend: float = 0.5,
    crossfade: int = 256,
    mesh=None,
) -> LongformResult:
    """Chunked long-form transfer with the reference's gram-translation trick
    applied per window, optionally through the NMF+OT palette transform.

    Args:
      engine: a StyleTransfer built for the window size (spec.batch_size).
      content_audio / style_audio: [T] float waveforms (any length).
      ot_components: if set, the style target is corrected by the
        OT-translated gram over that many NMF components per layer.
      ot_blend: weight of the OT translated-gram delta on the style target
        (0 = reference target untouched, 1 = full correction).
      crossfade: samples of linear crossfade when stitching windows.
      mesh: windows sharded over several devices; not ported yet.
    """
    if mesh is not None:
        raise NotImplementedError(
            "transfer_longform(mesh=...) is not ported yet (ROADMAP.md M8: multi-device)")
    window = engine.spec.batch_size
    windows = chunk_audio(content_audio, window)

    # Shared style statistics (chunk-averaged, methods.py:97-111).
    phi_t = engine.get_style_phi(style_audio, max_examples=max_style_examples)
    phi_s = engine.get_style_phi(content_audio, max_examples=max_style_examples)

    if ot_components is not None:
        phi_t = _ot_transform_gram(engine, style_audio, content_audio,
                                   phi_t, ot_components, blend=ot_blend)

    # Per-window content embeds and translated style targets stay on the
    # device between here and the optimizer.
    to_dev = engine._tensor
    phi_cs, phis = _window_targets(engine.params, to_dev(mu_law_numpy(windows)),
                                   to_dev(phi_t), to_dev(phi_s), engine.cfg,
                                   engine.loss_spec)
    result = engine.optimize_batch(phi_cs, phis, epochs=epochs)

    # Stitch windows with a short crossfade to hide seam discontinuities.
    outs = [inv_mu_law_numpy(result["x"][i, 0]) for i in range(windows.shape[0])]
    return LongformResult(audio=_stitch(outs, crossfade), per_window=result)


def ot_translated_gram(engine, style_audio, content_audio, n_components):
    """Full OT-translated gram: content features reconstructed in the
    OT-matched palette, per style layer, through the engine's own gram
    statistic.

      1. the relu'd content and style taps at layer i (NMF needs non-negative
         input) are factorized into palettes wc_i / ws_i [k, C];
      2. the content palette is OT-matched toward the style palette (the ADMM
         transport's barycentric projection);
      3. the content tap is reconstructed in the matched palette,
         f'_i = h_i @ w*_i with h_i the NMF activations of the content tap
         over its own palette (the reference's ``h @ W`` form,
         utils.py:139-145);
      4. the engine's gram statistic (channel-wise or Gatys, same nb_channels
         trim and l2 normalization) is built over all the reconstructed taps.

    Returns (g_ot, g_c, g_s) as numpy: the translated gram, and the
    same-construction (relu'd-tap) content and style grams, all l2-normalized
    and shaped like the engine's ``phi_t``.
    """
    window = engine.spec.batch_size
    lspec = engine.loss_spec
    style_ids = tuple(sorted(set(lspec.style_layer_ids)))

    def taps(aud):
        xq = engine._tensor(mu_law_numpy(aud[None, :window]))
        return _relu_taps(engine.params, xq, engine.cfg, style_ids)

    fc, fs = taps(content_audio), taps(style_audio)
    f_ot, rec_errs, pal_dists = _ot_translate(fc, fs, n_components)
    print(f"OT transform: nmf rec err {float(torch.mean(rec_errs)):.4f}, "
          f"palette shift {float(torch.mean(pal_dists)):.4f} "
          f"(mean over {len(style_ids)} layers)")
    return tuple(_stack_gram(f, lspec, style_ids).cpu().numpy() for f in (f_ot, fc, fs))


@torch.no_grad()
def _relu_taps(params, xq, cfg, style_ids):
    """relu'd [L, T, C] float32 style-layer taps of one window."""
    extracts, _ = encoder_extracts(params, xq, cfg, needed_taps=style_ids)
    return torch.stack([torch.relu(extracts[i][0].to(torch.float32)) for i in style_ids])


def _ot_translate(fc, fs, n_components: int, generator: torch.Generator | None = None):
    """All per-layer NMFs and OTs at once, the layer axis leading:
    (f_ot [L, T, C], nmf reconstruction error [L], palette shift [L]).
    ``generator`` seeds the NMF initial factors (content first, then style)."""
    generator = generator or torch.Generator().manual_seed(0)
    wc = nmf(fc, n_components, generator=generator)[1]  # content palettes [L, k, C]
    ws = nmf(fs, n_components, generator=generator)[1]  # style palettes   [L, k, C]
    wm = transform_palette(wc, ws, ot_admm(wc, ws))  # matched [L, k, C]
    h = nmf_transform(fc, wc)  # activations [L, T, k]
    f_ot = h @ wm

    def fro(a):
        return torch.sqrt(torch.sum(torch.square(a), dim=(-2, -1)))

    rec_err = fro(fc - h @ wc) / torch.clamp(fro(fc), min=1e-12)
    pal_dist = fro(wc - wm) / torch.clamp(fro(wc), min=1e-12)
    return f_ot, rec_err, pal_dist


@torch.no_grad()
def _stack_gram(stack, lspec, style_ids):
    """The engine's gram statistic over a [L, T, C] stack of taps."""
    tap_map = {i: stack[j][None] for j, i in enumerate(style_ids)}
    return style_gram(tap_map, lspec.style_layer_ids, gatys=lspec.gatys,
                      nb_channels=lspec.nb_channels).to(torch.float32)


def _ot_transform_gram(engine, style_audio, content_audio, phi_t,
                       n_components, blend: float = 0.5):
    """Style target with the full OT-translated gram blended in (config 5's
    "OT loss"). The correction is the delta between the translated and
    untranslated relu'd-tap grams, a same-space difference, so it is exactly
    zero when the transport is the identity. ``blend`` scales the delta:
    0 reproduces the reference target, 1 applies the full correction."""
    g_ot, g_c, _ = ot_translated_gram(engine, style_audio, content_audio, n_components)
    return l2_normalize(torch.as_tensor(phi_t + blend * (g_ot - g_c)), axes=(1, 2)).numpy()


SINGLE_WINDOW_MAX = 2_097_152  # samples; longer clips scan by default


def transfer_exact(
    engine: StyleTransfer,
    content_audio: np.ndarray,
    style_audio: np.ndarray,
    mesh=None,
    epochs: int | None = None,
    max_style_examples: int = 5,
    scan_window: int | None = None,
    ot_components: int | None = None,
    ot_blend: float = 0.5,
) -> LongformResult:
    """Exact long-form mode: one window spanning the whole clip.

    One global gram over the full sequence, no chunk seams, no crossfade,
    content features kept at every sample. Style statistics stay
    chunk-averaged as in the reference (methods.py:97-111): only the optimized
    window is global. Per-epoch L-BFGS restarts (zoom, no restart on a failed
    search) and the ``< early_stop_evals`` stop follow the engine's spec.

    Clips up to ``SINGLE_WINDOW_MAX`` samples run as one unmasked trunk pass
    (the whole clip's taps and mask bytes are live); longer ones, or any clip
    when ``scan_window`` is given and shorter than it, run as a scan over
    ``scan_window``-sample halo-extended windows whose live memory is one
    window's (``halo.make_scan_exact_value_and_grad_fn``).

    ``ot_components`` / ``ot_blend``: as in ``transfer_longform``; the
    correction applies to the chunk-averaged ``phi_t`` before the gram
    translation.

    The clip is trimmed to a multiple of 4096 samples in single-window mode.
    Scan mode trims to a multiple of 512 and zero-pads up to whole windows,
    the pad masked out of the loss. ``per_window`` holds ``metrics`` (the
    loss after each epoch), ``evals``, ``epochs_done``, ``t_optimized`` (the
    length the loss ran over: in scan mode the padded one, which is what a
    per-evaluation cost divides by) and ``x`` [1, t_optimized].

    ``mesh``: the time-sharded form over several devices; not ported yet.
    """
    from audio_style_transfer_tpu_torch.parallel.halo import (
        make_scan_exact_embeds_fn,
        make_scan_exact_value_and_grad_fn,
    )
    from audio_style_transfer_tpu_torch.transfer.lbfgs import LBFGSOptions, lbfgs_minimize

    if mesh is not None:
        raise NotImplementedError(
            "transfer_exact(mesh=...) is not ported yet (ROADMAP.md M8: multi-device)")
    spec = engine.spec
    epochs = epochs or spec.epochs
    if scan_window is None:
        scan_window = (len(content_audio) if len(content_audio) <= SINGLE_WINDOW_MAX
                       else 32768)
    if scan_window >= len(content_audio):  # single-window mode
        quantum, scan_window = 4096, len(content_audio)
    else:
        quantum = 512
    t_valid = (len(content_audio) // quantum) * quantum
    if t_valid == 0:
        raise ValueError(f"content ({len(content_audio)} samples) shorter than one "
                         f"{quantum}-sample quantum")
    if scan_window < t_valid:
        # Scan mode: pad to whole windows; the pad is masked out of the loss.
        t_total = -(-t_valid // scan_window) * scan_window
    else:
        t_total = t_valid
    content = np.pad(content_audio[:t_valid], (0, t_total - t_valid))

    # Reference-semantics style statistics (chunk-averaged).
    phi_t = engine.get_style_phi(style_audio, max_examples=max_style_examples)
    phi_s = engine.get_style_phi(content_audio, max_examples=max_style_examples)
    if ot_components is not None:
        phi_t = _ot_transform_gram(engine, style_audio, content_audio,
                                   phi_t, ot_components, blend=ot_blend)

    geometry = (engine.cfg, engine.loss_spec, t_total, scan_window, t_valid)
    embeds_fn = make_scan_exact_embeds_fn(*geometry)
    value_and_grad = make_scan_exact_value_and_grad_fn(*geometry)

    # Full-sequence content targets through one exact encoder pass.
    to_dev = engine._tensor
    with torch.no_grad():
        phi_c, phi_full = embeds_fn(engine.params, to_dev(mu_law_numpy(content[None])))
        phi_c = phi_c.to(torch.float32)
        phi = l2_normalize(phi_full.to(torch.float32) + to_dev(phi_t) - to_dev(phi_s),
                           axes=(1, 2))

    def vg(x):
        loss, g = value_and_grad(engine.params, x[None, :], phi_c, phi)
        return loss, g[0]

    opts = LBFGSOptions(maxiter=spec.maxiter, line_search="zoom", restart_on_ls_fail=False)
    x = to_dev(np.full((t_total,), 1e-6, np.float32))
    metrics, evals = [], []
    for _ in range(epochs):
        res = lbfgs_minimize(vg, x, opts)
        x = res.x
        metrics.append(float(res.f))
        evals.append(int(res.n_evals))
        if evals[-1] < spec.early_stop_evals:
            break

    x_np = x.detach().cpu().numpy()[None, :]
    return LongformResult(
        audio=inv_mu_law_numpy(x_np[0, :t_valid]),
        per_window={
            "metrics": np.asarray(metrics, np.float32),
            "evals": np.asarray(evals, np.int32),
            "epochs_done": len(evals),
            "t_optimized": int(t_total),
            "x": x_np,
        },
    )


def _stitch(windows: list[np.ndarray], crossfade: int) -> np.ndarray:
    if not windows:
        return np.zeros(0, np.float32)
    if crossfade <= 0 or len(windows) == 1:
        return np.concatenate(windows)
    out = [windows[0]]
    ramp = np.linspace(0.0, 1.0, crossfade, dtype=np.float32)
    for w in windows[1:]:
        prev = out[-1]
        blended = prev[-crossfade:] * (1 - ramp) + w[:crossfade] * ramp
        out[-1] = prev[:-crossfade]
        out.append(blended)
        out.append(w[crossfade:])
    return np.concatenate(out)
