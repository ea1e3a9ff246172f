"""Gram-matrix grids, activation and gram panels, NMF palette plots
(reference utils.py:107-257, output-grams.py:69-77): the port's own copy of
audio_style_transfer_tpu/analysis/viz.py. matplotlib is imported at the
call."""

from __future__ import annotations

import os

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("agg")
    from matplotlib import pyplot as plt

    return plt


def show_our_gram(mats, ep=None, figdir=None):
    """Grid of per-channel layer x layer grams (reference utils.py:223-235)."""
    plt = _plt()
    figs_col = 8
    nb_chnnls = mats.shape[0]
    ncols = max(nb_chnnls // figs_col, 1)
    fig, axs = plt.subplots(
        figs_col, ncols, figsize=(12 * ncols, 10 * figs_col), squeeze=False
    )
    for i in range(figs_col):
        for j in range(ncols):
            k = i + j * figs_col
            if k >= nb_chnnls:
                continue
            axs[i, j].imshow(mats[k], interpolation="nearest", cmap=plt.cm.plasma)
            axs[i, j].set_title(f"channel {k}")
    if figdir is not None:
        name = f"gram-ep{ep}.png" if ep is not None else "gram-style.png"
        fig.savefig(os.path.join(figdir, name), dpi=5)
    plt.close(fig)


def show_gatys_gram(mats, ep=None, figdir=None):
    """Grid of per-layer channel x channel grams (reference utils.py:238-250)."""
    plt = _plt()
    figs_col = 2
    nb_lyrs = mats.shape[0]
    ncols = max(nb_lyrs // figs_col, 1)
    fig, axs = plt.subplots(
        figs_col, ncols, figsize=(12 * ncols, 12 * figs_col), squeeze=False
    )
    for i in range(figs_col):
        for j in range(ncols):
            k = i + j * figs_col
            if k >= nb_lyrs:
                continue
            axs[i, j].imshow(mats[k], interpolation="nearest", cmap=plt.cm.plasma)
            axs[i, j].set_title(f"channel {k}")
    if figdir is not None:
        name = f"gram-ep{ep}.png" if ep is not None else "gram-style.png"
        fig.savefig(os.path.join(figdir, name), dpi=20)
    plt.close(fig)


def show_gram(mats, ep=None, figdir=None, gatys: bool = False):
    """Dispatch like reference utils.py:253-257."""
    mats = np.asarray(mats)
    if gatys:
        show_gatys_gram(mats, ep, figdir)
    else:
        show_our_gram(mats, ep, figdir)


def vis_actis(aud, enc, fig_dir, ep, layers, nb_channels=5, dspl=64,
              output_file=False, sr=16000):
    """Per-layer activation triptychs (reference utils.py:148-167)."""
    plt = _plt()
    enc = np.asarray(enc)
    nb_layers = enc.shape[0]
    fig, axs = plt.subplots(nb_layers + 1, 3, figsize=(30, 5 * (nb_layers + 1)))
    axs[0, 1].plot(aud)
    axs[0, 1].set_title("Audio Signal")
    axs[0, 0].axis("off")
    axs[0, 2].axis("off")
    for i in range(nb_layers):
        for part in range(3):
            seg = enc[i, part * dspl : (part + 1) * dspl, :nb_channels]
            axs[i + 1, part].plot(np.log(seg + 1))
            axs[i + 1, part].set_title(f"Embeds layer {layers[i]} part {part}")
    sp = os.path.join(fig_dir, f"f-{ep}")
    plt.savefig(sp + ".png", dpi=50)
    plt.close(fig)
    if output_file:
        from audio_style_transfer_tpu_torch.utils.audio_io import write_wav

        write_wav(sp + ".wav", aud, sr=sr)


def vis_actis_ens(aud, enc, fig_dir, ep, layer_ids, nb_channels=5, dspl=256,
                  output_file=False, sr=16000):
    """Windowed min/max/std/mean activation summaries (utils.py:170-196)."""
    plt = _plt()
    enc = np.asarray(enc)
    nb_layers = enc.shape[0]
    fig, axs = plt.subplots(nb_layers + 1, 3, figsize=(30, 5 * (nb_layers + 1)))
    axs[0, 1].plot(aud)
    axs[0, 1].set_title("Audio Signal")
    axs[0, 0].axis("off")
    axs[0, 2].axis("off")
    for i in range(nb_layers):
        a = np.reshape(enc[i, :, :nb_channels], [-1, dspl, nb_channels])
        std = np.std(a, axis=1)
        mean = np.mean(a, axis=1)
        axs[i + 1, 0].plot(a.min(axis=1))
        axs[i + 1, 0].plot(a.max(axis=1))
        axs[i + 1, 0].set_title(f"embeds layer {layer_ids[i]} -- MIN/MAX")
        axs[i + 1, 1].plot(std + mean)
        axs[i + 1, 1].plot(-std + mean)
        axs[i + 1, 1].set_title(f"embeds layer {layer_ids[i]} -- STD/MEAN")
        axs[i + 1, 2].plot(mean)
        axs[i + 1, 2].set_title(f"embeds layer {layer_ids[i]} -- AVG")
    sp = os.path.join(fig_dir, f"fe-{ep}")
    plt.savefig(sp + ".png", dpi=50)
    plt.close(fig)
    if output_file:
        from audio_style_transfer_tpu_torch.utils.audio_io import write_wav

        write_wav(sp + ".wav", aud, sr=sr)


def vis_mats(phis, phit, layer_ids, figdir=None, srcname=None, trgname=None):
    """Side-by-side source/target gram panels (reference utils.py:198-220)."""
    plt = _plt()
    phis, phit = np.asarray(phis), np.asarray(phit)
    fig, axs = plt.subplots(
        len(layer_ids) + 1, 2, figsize=(40, 10 * len(layer_ids) + 1), squeeze=False
    )
    if srcname:
        axs[0, 0].set_title(srcname)
    if trgname:
        axs[0, 1].set_title(trgname)
    axs[0, 0].imshow(
        phis.reshape(phis.shape[0], -1) if phis.ndim == 3 else phis,
        interpolation="nearest", cmap=plt.cm.plasma, aspect="auto",
    )
    axs[0, 1].imshow(
        phit.reshape(phit.shape[0], -1) if phit.ndim == 3 else phit,
        interpolation="nearest", cmap=plt.cm.plasma, aspect="auto",
    )
    im = None
    for i in layer_ids:
        axs[i + 1, 0].set_title(f"layer-{layer_ids[i]}")
        axs[i + 1, 0].imshow(phis[i], interpolation="nearest", cmap=plt.cm.plasma)
        axs[i + 1, 1].set_title(f"layer-{layer_ids[i]}")
        im = axs[i + 1, 1].imshow(phit[i], interpolation="nearest", cmap=plt.cm.plasma)
    if im is not None:
        fig.subplots_adjust(right=0.8)
        cbar_ax = fig.add_axes([0.85, 0.15, 0.05, 0.7])
        fig.colorbar(im, cax=cbar_ax)
    if figdir:
        fig.savefig(os.path.join(figdir, "mats_plt.png"), dpi=100)
    plt.close(fig)


def show_inten(mats, ep, figdir):
    """Per-channel gram-norm intensity plot (reference output-grams.py:69-77)."""
    plt = _plt()
    mats = np.asarray(mats)
    a = np.array([np.linalg.norm(mats[i]) for i in range(mats.shape[0])])
    plt.plot(a)
    plt.savefig(os.path.join(figdir, f"int{ep}"), dpi=100)
    plt.close()
    return a


def compare_2_matrix(ws, wt, figdir):
    """NMF palette comparison plots (reference utils.py:107-129)."""
    plt = _plt()
    ws, wt = np.asarray(ws), np.asarray(wt)
    figs, axs = plt.subplots(1, 2, figsize=(10, 40))
    axs[0].set_aspect("equal")
    im0 = axs[0].imshow(ws, interpolation="nearest", cmap=plt.cm.ocean)
    axs[1].set_aspect("equal")
    im1 = axs[1].imshow(wt, interpolation="nearest", cmap=plt.cm.ocean)
    plt.colorbar(im0, ax=axs[0])
    plt.colorbar(im1, ax=axs[1])
    plt.savefig(os.path.join(figdir, "ws-wt.png"), dpi=50)
    plt.close(figs)

    rows, cols = ws.shape
    for i in range(cols):
        figs, axs = plt.subplots(1, 2, figsize=(20, 5))
        axs[0].plot(ws[:, i])
        axs[0].set_ylim(top=1.0)
        axs[1].plot(wt[:, i])
        axs[1].set_ylim(top=1.0)
        plt.savefig(os.path.join(figdir, f"ws-wt-col{i}.png"), dpi=50)
        plt.close(figs)

    np.save(os.path.join(figdir, "ws"), arr=ws)
    np.save(os.path.join(figdir, "wt"), arr=wt)
