"""Transfer loss (counterpart of audio_style_transfer_tpu/transfer/losses.py).

  content = mean((F(x) - phi_c)^2) * 10
  style   = mean((G(x) - phi_s)^2) * 1e3
  loss    = content + lambd * style + gamma * reg
(reference methods.py:113-131). The STFT regularizer (gamma != 0) is not
ported yet: see ROADMAP's ``stft_l1`` item.
"""

from __future__ import annotations

import dataclasses

import torch

from audio_style_transfer_tpu_torch.models.wavenet_ae import (
    WaveNetAEConfig,
    encoder_extracts,
)
from audio_style_transfer_tpu_torch.transfer.grams import content_embeds, style_gram


@dataclasses.dataclass(frozen=True)
class LossSpec:
    cont_lyr_ids: tuple = (29,)
    style_layer_ids: tuple = tuple(range(30))
    cnt_channels: int = 128
    nb_channels: int = 128
    gatys: bool = False
    lambd: float = 100.0
    gamma: float = 0.0


def transfer_embeds(params, x_quantized: torch.Tensor, cfg: WaveNetAEConfig,
                    spec: LossSpec):
    """(content embed, style gram), float32, of a [1, T] quantized waveform."""
    needed = tuple(sorted(set(spec.cont_lyr_ids) | set(spec.style_layer_ids)))
    extracts, _ = encoder_extracts(params, x_quantized, cfg, needed_taps=needed)
    c = content_embeds(extracts, spec.cont_lyr_ids, spec.cnt_channels)
    s = style_gram(extracts, spec.style_layer_ids, gatys=spec.gatys,
                   nb_channels=spec.nb_channels)
    return c.to(torch.float32), s.to(torch.float32)


def transfer_loss(params, x_quantized: torch.Tensor, phi_c: torch.Tensor,
                  phi_s: torch.Tensor, cfg: WaveNetAEConfig, spec: LossSpec):
    """Scalar loss and its components dict for a [1, T] quantized waveform."""
    if spec.gamma != 0.0:
        raise NotImplementedError(
            "gamma != 0 needs the STFT L1 regularizer, not ported yet "
            "(ROADMAP.md: stft_l1)")
    c, s = transfer_embeds(params, x_quantized, cfg, spec)
    content_loss = torch.mean(torch.square(c - phi_c)) * 10.0
    style_loss = torch.mean(torch.square(s - phi_s)) * 1e3
    regularizer = torch.zeros((), dtype=torch.float32, device=content_loss.device)
    loss = content_loss + spec.lambd * style_loss + spec.gamma * regularizer
    return loss, {
        "loss": loss,
        "content_loss": content_loss,
        "style_loss": style_loss,
        "regularizer": regularizer,
    }
