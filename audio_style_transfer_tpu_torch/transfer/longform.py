"""Long-form (60 s+) style transfer by chunking (counterpart of
audio_style_transfer_tpu/transfer/longform.py, chunked mode).

The waveform is split into batch_size windows; every window gets its own
content target and a shared (chunk-averaged, gram-translated) style target,
and the windows run one after another through the engine's single-clip
optimizer (``optimize_batch``), then are stitched with a short crossfade.

Optionally the style target is first mapped through the NMF + optimal
transport palette transform (reference utils.py:132-145), the "OT loss"
flavour of BASELINE.json config 5.

Exact mode (one window spanning the whole clip, ``transfer_exact``) is not
ported yet.
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


def transfer_exact(*args, **kwargs):
    """Exact long-form mode (one window spanning the whole clip): not ported."""
    raise NotImplementedError(
        "transfer_exact is not ported yet (ROADMAP.md M5-exact: exact long-form)")


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
