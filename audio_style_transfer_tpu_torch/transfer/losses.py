"""Transfer loss (counterpart of audio_style_transfer_tpu/transfer/losses.py).

  content = mean((F(x) - phi_c)^2) * 10
  style   = mean((G(x) - phi_s)^2) * 1e3
  reg     = mean(|Re STFT(inv_mu_law(x))| + |Im STFT|)   (frames 1024/512)
  loss    = content + lambd * style + gamma * reg
(reference methods.py:113-131). The regularizer is built only when
gamma != 0.

``weighted_loss`` is that sum, and ``needed_taps`` the encoder taps a
``LossSpec`` reads. Every evaluation of the loss is built from them: the
clip's here (``transfer_loss``), and the exact whole-clip one on one device,
as a window scan or over the ranks of a mesh (``parallel/halo.py``). Each
brings its own content mean and gram, which the exact ones sum over windows
or ranks in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from audio_style_transfer_tpu_torch.models.wavenet_ae import (
    WaveNetAEConfig,
    encoder_extracts,
)
from audio_style_transfer_tpu_torch.signal.mu_law import inv_mu_law
from audio_style_transfer_tpu_torch.signal.stft import stft_l1
from audio_style_transfer_tpu_torch.transfer.grams import (
    content_embeds,
    gram_sums,
    normalize_gram,
    style_gram,
)

CONTENT_WEIGHT, STYLE_WEIGHT = 10.0, 1e3
FRAME_LENGTH, FRAME_STEP = 1024, 512  # the regularizer's STFT frames


@dataclasses.dataclass(frozen=True)
class LossSpec:
    cont_lyr_ids: tuple = (29,)
    style_layer_ids: tuple = tuple(range(30))
    cnt_channels: int = 128
    nb_channels: int = 128
    gatys: bool = False
    lambd: float = 100.0
    gamma: float = 0.0


def needed_taps(spec: LossSpec) -> tuple:
    """The encoder taps the loss reads, ascending: content and style layers."""
    return tuple(sorted(set(spec.cont_lyr_ids) | set(spec.style_layer_ids)))


def content_of(extracts, spec: LossSpec) -> torch.Tensor:
    """The content embed of a clip's, a window's or a rank's taps, in their
    dtype."""
    return content_embeds(extracts, spec.cont_lyr_ids, spec.cnt_channels)


def gram_sums_of(extracts, spec: LossSpec) -> torch.Tensor:
    """The unnormalized float32 gram of a clip's, a window's or a rank's
    style taps: the windows' or ranks' sums add up to the clip's."""
    return gram_sums(extracts, spec.style_layer_ids, gatys=spec.gatys)


def style_of(gram_sum: torch.Tensor, spec: LossSpec) -> torch.Tensor:
    """The normalized style gram of a whole clip's gram sums."""
    return normalize_gram(gram_sum, gatys=spec.gatys, nb_channels=spec.nb_channels)


def mean_square(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """mean((a - b)^2) in float32."""
    return torch.mean(torch.square(a.to(torch.float32) - b.to(torch.float32)))


def stft_regularizer(x_quantized: torch.Tensor) -> torch.Tensor:
    """The regularizer of a [1, T] quantized waveform."""
    return stft_l1(inv_mu_law(x_quantized[0]), frame_length=FRAME_LENGTH,
                   frame_step=FRAME_STEP)


def weighted_loss(spec: LossSpec, content: torch.Tensor, gram: torch.Tensor,
                  phi_s: torch.Tensor, regularizer: Callable[[], torch.Tensor]):
    """(loss, content term, style term, regularizer or None) from the content
    mean square ``content`` and the normalized style gram ``gram``. The
    regularizer is called, and its term added, only when gamma != 0: with
    gamma == 0 the loss holds no op of it."""
    content_loss = content * CONTENT_WEIGHT
    style_loss = mean_square(gram, phi_s) * STYLE_WEIGHT
    loss = content_loss + spec.lambd * style_loss
    reg = None
    if spec.gamma != 0.0:
        reg = regularizer()
        loss = loss + spec.gamma * reg
    return loss, content_loss, style_loss, reg


def transfer_embeds(params, x_quantized: torch.Tensor, cfg: WaveNetAEConfig,
                    spec: LossSpec):
    """(content embed, style gram), float32, of a [1, T] quantized waveform."""
    extracts, _ = encoder_extracts(params, x_quantized, cfg, needed_taps=needed_taps(spec))
    c = content_of(extracts, spec)
    s = style_gram(extracts, spec.style_layer_ids, gatys=spec.gatys,
                   nb_channels=spec.nb_channels)
    return c.to(torch.float32), s.to(torch.float32)


def transfer_loss(params, x_quantized: torch.Tensor, phi_c: torch.Tensor,
                  phi_s: torch.Tensor, cfg: WaveNetAEConfig, spec: LossSpec):
    """Scalar loss and its components dict for a [1, T] quantized waveform."""
    c, s = transfer_embeds(params, x_quantized, cfg, spec)
    loss, content_loss, style_loss, regularizer = weighted_loss(
        spec, mean_square(c, phi_c), s, phi_s, lambda: stft_regularizer(x_quantized))
    if regularizer is None:
        regularizer = torch.zeros((), dtype=torch.float32, device=content_loss.device)
    return loss, {
        "loss": loss,
        "content_loss": content_loss,
        "style_loss": style_loss,
        "regularizer": regularizer,
    }
