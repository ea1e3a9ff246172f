"""Gram-matrix grid and NMF palette plots (reference utils.py:107-129,
223-257): the port's own copy of ``show_gram`` and ``compare_2_matrix`` from
audio_style_transfer_tpu/analysis/viz.py. matplotlib is imported at the call."""

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
