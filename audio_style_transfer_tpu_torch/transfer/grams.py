"""Feature embeddings and gram statistics (counterpart of
audio_style_transfer_tpu/transfer/grams.py).

"ours": channel-wise grams [C, L, L] over the selected taps, through
``ops.gram.pair_gram`` (the K5 kernel on CUDA). Gatys: per-layer channel x
channel grams [L, C, C], through ``ops.gram.layer_gram`` (K8f on CUDA; JAX
computes it outside any kernel). ``gram_sums`` gives either in float32,
unnormalized; ``style_gram`` casts it to the taps' dtype and l2-normalizes it
over its trailing two axes (``normalize_gram``).
"""

from __future__ import annotations

from typing import Sequence

import torch

from audio_style_transfer_tpu_torch.ops.gram import layer_gram, pair_gram


def l2_normalize(x: torch.Tensor, axes=(1, 2), eps: float = 1e-12) -> torch.Tensor:
    """tf.nn.l2_normalize semantics: x / sqrt(max(sum(x^2), eps))."""
    sq = torch.sum(torch.square(x), dim=tuple(axes), keepdim=True)
    return x * torch.reciprocal(torch.sqrt(torch.clamp(sq, min=eps)))


def select_style_layers(num_layers: int = 30, stack: int | None = None,
                        style_lyr_ids: Sequence[int] | None = None) -> list[int]:
    """Layer-id selection logic of reference methods.py:60-66."""
    if style_lyr_ids is not None:
        if not isinstance(style_lyr_ids, (tuple, list)):
            raise TypeError("style_lyr_ids must be of type tuple or list!")
        return list(style_lyr_ids)
    if stack is not None:
        return list(range(stack * 10, stack * 10 + 10))
    return list(range(num_layers))


def content_embeds(extracts, cont_lyr_ids: Sequence[int], cnt_channels: int = 128):
    """[T, cnt_channels * len(ids)] content feature (methods.py:58)."""
    return torch.cat([extracts[i][:, :, :cnt_channels] for i in cont_lyr_ids], dim=2)[0]


def gram_sums(extracts, layer_ids: Sequence[int], *, gatys: bool = False) -> torch.Tensor:
    """Unnormalized float32 gram of the selected taps of a batch-1 clip or
    window: [C, L, L] through the all-pairs gram, or for Gatys [L, C, C]
    through the per-layer gram. Grams are time sums, so the sums of a clip's
    windows add up to the clip's."""
    taps = [extracts[i] for i in layer_ids]
    if gatys:
        return layer_gram(*taps)
    return pair_gram(*taps)[0].permute(2, 0, 1)  # [1, L, L, C] -> [C, L, L]


def normalize_gram(gram: torch.Tensor, *, gatys: bool = False,
                   nb_channels: int = 128) -> torch.Tensor:
    """l2-normalize a gram over its trailing two axes; a channel-wise gram
    keeps its first ``nb_channels`` channels."""
    gram = l2_normalize(gram, axes=(1, 2))
    if nb_channels < gram.shape[0] and not gatys:
        gram = gram[:nb_channels]
    return gram


def style_gram(extracts, layer_ids: Sequence[int], *, gatys: bool = False,
               nb_channels: int = 128) -> torch.Tensor:
    """Normalized gram over the selected taps of a batch-1 clip: [C, L, L]
    ("ours") or [L, C, C] (Gatys), in the taps' dtype."""
    dtype = extracts[layer_ids[0]].dtype
    return normalize_gram(gram_sums(extracts, layer_ids, gatys=gatys).to(dtype), gatys=gatys,
                          nb_channels=nb_channels)
