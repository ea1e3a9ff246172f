"""Spectrogram / audio / metric summaries (counterpart of
audio_style_transfer_tpu/analysis/summaries.py; reference
nsynth/utils.py:439-636).

The reference posts TensorBoard image grids of spectrogram batches, audio
reconstructions through inverse-specgram py_funcs, and softmax / L2 scalar
families. Here the equivalents write PNG grids and wav files and return
scalars; the audio comes from the port's ``ispecgram`` on a torch device.
matplotlib is imported at the call.
"""

from __future__ import annotations

import os

import numpy as np


def form_image_grid(batch: np.ndarray, grid_shape, image_shape, num_channels: int):
    """Arrange [B, H, W, C] (or flattened) images into one grid image
    (reference nsynth/utils.py:439-483). Returns [1, gh*H, gw*W, C]."""
    batch = np.asarray(batch)
    gh, gw = grid_shape
    if batch.shape[0] != gh * gw:
        raise ValueError("Grid shape incompatible with minibatch size.")
    if batch.ndim == 2:
        expected = image_shape[0] * image_shape[1] * num_channels
        if batch.shape[1] != expected:
            raise ValueError(
                "Image shape and number of channels incompatible with input tensor."
            )
        batch = batch.reshape([gh * gw] + list(image_shape) + [num_channels])
    elif batch.ndim == 4:
        if (batch.shape[1] != image_shape[0] or batch.shape[2] != image_shape[1]
                or batch.shape[3] != num_channels):
            raise ValueError(
                "Image shape and number of channels incompatible with input tensor."
            )
    else:
        raise ValueError("Unrecognized input tensor format.")
    h, w = image_shape
    grid = batch.reshape(gh, gw, h, w, num_channels)
    grid = grid.transpose(0, 2, 1, 3, 4).reshape(1, gh * h, gw * w, num_channels)
    return grid


def specgram_summaries(
    spec,
    name: str,
    hparams,
    outdir: str,
    rows: int = 4,
    columns: int = 4,
    image: bool = True,
    phase: bool = True,
    audio: bool = True,
    device="cuda",
):
    """Image grids and reconstructed audio (``ispecgram`` with 50
    Griffin-Lim iterations on ``device``) for a specgram batch [B, F, N, C]
    (reference nsynth/utils.py:486-546), written under ``outdir``."""
    import matplotlib

    matplotlib.use("agg")
    import torch
    from matplotlib import pyplot as plt

    from audio_style_transfer_tpu_torch.signal.specgram import ispecgram
    from audio_style_transfer_tpu_torch.utils.audio_io import write_wav

    os.makedirs(outdir, exist_ok=True)
    spec = np.asarray(spec)
    batch_size, n_freq, n_time, _ = spec.shape
    b = min(batch_size, rows * columns)
    if b % columns != 0:
        rows = columns = int(np.floor(np.sqrt(b)))
    else:
        rows = b // columns

    safe = name.replace("/", "_").replace(" ", "_")
    if image and rows * columns:
        grid = form_image_grid(
            spec[: rows * columns, :, :, :1], [rows, columns], [n_freq, n_time], 1
        )
        plt.imsave(os.path.join(outdir, f"mag_{safe}.png"), grid[0, :, :, 0],
                   cmap="magma")
        if phase and spec.shape[-1] > 1:
            grid = form_image_grid(
                spec[: rows * columns, :, :, 1:2], [rows, columns],
                [n_freq, n_time], 1,
            )
            plt.imsave(os.path.join(outdir, f"phase_{safe}.png"),
                       grid[0, :, :, 0], cmap="twilight")
    if audio:
        for i in range(min(b, 4)):
            wav = ispecgram(
                torch.as_tensor(spec[i], device=device),
                n_fft=hparams.n_fft,
                hop_length=hparams.hop_length,
                mask=hparams.mask,
                log_mag=hparams.log_mag,
                re_im=hparams.re_im,
                dphase=hparams.dphase,
                mag_only=hparams.mag_only,
                num_iters=50,
            ).cpu().numpy()
            write_wav(os.path.join(outdir, f"{safe}_{i}.wav"), wav,
                      hparams.samples_per_second)


def softmax_metrics(logits, labels) -> dict:
    """Cross-entropy + precision@1/@5 scalars (reference utils.py:549-611)."""
    logits = np.asarray(logits)
    labels = np.asarray(labels)
    if labels.ndim == 2:
        labels = labels.argmax(axis=1)
    logp = logits - logits.max(axis=1, keepdims=True)
    logp = logp - np.log(np.exp(logp).sum(axis=1, keepdims=True))
    loss = -logp[np.arange(len(labels)), labels].mean()
    order = np.argsort(-logits, axis=1)
    top1 = (order[:, 0] == labels).mean()
    top5 = np.any(order[:, :5] == labels[:, None], axis=1).mean()
    return {"loss": float(loss), "precision@1": float(top1),
            "precision@5": float(top5)}


def l2_metrics(predicted, true) -> dict:
    """L2 loss family (reference nsynth/utils.py:614-636)."""
    predicted, true = np.asarray(predicted), np.asarray(true)
    return {
        "loss": float(np.mean((predicted - true) ** 2)),
        "prediction_mean_squared_norm": float(np.mean(0.5 * (predicted**2).sum(-1))),
        "label_mean_squared_norm": float(np.mean(0.5 * (true**2).sum(-1))),
    }
