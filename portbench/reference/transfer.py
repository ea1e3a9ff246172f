"""Style-transfer targets and loss in plain PyTorch (winlp4ever/audio_style_transfer
``methods.py``: content taps, grams of the style taps).

A clip's features: the content feature is tap ``content`` [T, C]; the style
statistic is the gram of the style taps per channel, G[c, a, b] = sum_t
tap_a[t, c] tap_b[t, c], normalized over (a, b) and cut to ``nb_channels``
channels; or, with ``gatys``, each style tap's own gram over its channels,
G[l, a, b] = sum_t tap_l[t, a] tap_l[t, b], normalized over (a, b), with no
cut (``methods.py:71,73``). The style taps are ``style_lyr_ids``, else the
ten of ``stack``, else every trunk layer (``methods.py:60-66``). A long style
clip gives the mean of its windows' statistics. The target handed to the
optimizer is l2n(G(content) + phi(style) - phi(source)), the gram
translation, with the content clip as its own source. The loss of a
waveform x (mu-law space) is 10 mean((F(x) - phi_c)^2) + lambd 1e3
mean((G(x) - target)^2).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import nsynth
from portbench.reference.lowp import EXACT


def style_taps(cfg: dict) -> tuple[int, ...]:
    """The style taps of a configuration."""
    if cfg.get("style_lyr_ids") is not None:
        return tuple(cfg["style_lyr_ids"])
    if cfg.get("stack") is not None:
        return tuple(range(cfg["stack"] * 10, cfg["stack"] * 10 + 10))
    return tuple(range(cfg["ae_num_layers"]))


def statistic_shape(cfg: dict) -> tuple[int, int, int]:
    """The shape of a clip's style statistic: [nb_channels, L, L], or with
    ``gatys`` [L, C, C]."""
    taps, c = len(style_taps(cfg)), cfg["ae_width"]
    return (taps, c, c) if cfg.get("gatys") else (min(cfg["nb_channels"], c), taps, taps)


def l2_normalize(g: torch.Tensor) -> torch.Tensor:
    sq = torch.sum(torch.square(g), dim=(1, 2), keepdim=True)
    return g / torch.sqrt(torch.clamp(sq, min=1e-12))


class Loss:
    """The transfer loss of one configuration and encoder weights."""

    def __init__(self, params, cfg: dict, q=EXACT):
        self.params, self.cfg, self.q = params, cfg, q
        self.style = style_taps(cfg)
        self.content = tuple(cfg["cont_lyr_ids"])
        if cfg.get("gamma", 0.0) != 0.0:
            raise ValueError("the reference covers gamma = 0 only")

    def features(self, xq: torch.Tensor):
        """(content feature [T, C], normalized statistic: ``statistic_shape``)
        of one mu-law clip [T] (a tensor on the reference's device)."""
        taps, _ = nsynth.encoder(self.params, xq[None], self.cfg,
                                 taps=set(self.style) | set(self.content), q=self.q)
        c = torch.cat([taps[i][0, :, :self.cfg["cnt_channels"]] for i in self.content], dim=1)
        stacked = torch.stack([taps[i][0] for i in self.style])  # [L, T, C]
        if self.cfg.get("gatys"):
            return c, l2_normalize(torch.einsum("lta,ltb->lab", stacked, stacked))
        gram = torch.einsum("atc,btc->cab", stacked, stacked)
        return c, l2_normalize(gram)[:self.cfg["nb_channels"]]

    def style_phi(self, audio: np.ndarray, window: int, max_examples: int = 5) -> torch.Tensor:
        """The mean normalized statistic over the first windows of a clip."""
        n = max(min(len(audio), max_examples * window) // window, 1)
        grams = [self.features(self._quantized(audio[i * window:(i + 1) * window]))[1]
                 for i in range(n)]
        return torch.stack(grams).mean(dim=0)

    def _quantized(self, audio: np.ndarray) -> torch.Tensor:
        dev = self.params["ae_startconv"]["w"].device
        return torch.as_tensor(nsynth.mu_law_floor(audio), dtype=torch.float32, device=dev)

    def targets(self, content: np.ndarray, style: np.ndarray, window: int):
        """(phi_c, target) of a content clip (one window, or the whole clip
        as one global window) and a style clip, statistics averaged over up
        to five ``window``-sample windows of each."""
        phi_t = self.style_phi(style, window)
        phi_s = self.style_phi(content, window)
        phi_c, gram = self.features(self._quantized(content))
        return phi_c, l2_normalize(gram + phi_t - phi_s)

    def __call__(self, x: torch.Tensor, phi_c: torch.Tensor, target: torch.Tensor):
        """(loss, content loss, style loss) of a mu-law-space waveform x [T]."""
        c, g = self.features(x)
        content = torch.mean(torch.square(c - phi_c)) * 10.0
        style = torch.mean(torch.square(g - target)) * 1e3
        return content + self.cfg["lambd"] * style, content, style
