"""Weights carried across from the JAX package (counterpart of
audio_style_transfer_tpu/ckpt/convert.py).

The JAX ``save_params`` writes a flat ``.npz`` with keys ``<layer>/w``
([F, Cin, Cout]) and ``<layer>/b``; this module reads it with numpy alone
and returns torch tensors. Converting the pretrained TF1 bundle stays with
the JAX package's converter, which writes that ``.npz``.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def params_from_numpy(params_np, device: torch.device | str = "cpu",
                      dtype: torch.dtype = torch.float32) -> dict:
    """{layer: {name: array}} of numpy arrays -> the same dict of tensors."""
    return {
        layer: {k: torch.tensor(np.asarray(v), dtype=dtype, device=device)
                for k, v in entry.items()}
        for layer, entry in params_np.items()
    }


def load_params(path: str, device: torch.device | str = "cpu") -> dict:
    """Read the ``.npz`` written by the JAX ``save_params``."""
    with np.load(path) as data:
        flat: dict = {}
        for key in data.files:
            layer, k = key.rsplit("/", 1)
            flat.setdefault(layer, {})[k] = data[key]
    return params_from_numpy(flat, device)


def load_pretrained(checkpoint_path: str, device: torch.device | str = "cpu") -> dict:
    """Pretrained weights from ``<ckpt>.npz`` or a path ending in ``.npz``."""
    npz_path = checkpoint_path + ".npz"
    if os.path.exists(npz_path):
        return load_params(npz_path, device)
    if checkpoint_path.endswith(".npz") and os.path.exists(checkpoint_path):
        return load_params(checkpoint_path, device)
    raise FileNotFoundError(
        f"no converted weights at {npz_path}: TF1 checkpoint bundles are read "
        "by the JAX package's converter. Run "
        "audio_style_transfer_tpu.ckpt.convert.load_pretrained(path) once (it "
        "caches <ckpt>.npz), or convert_tf1_checkpoint + save_params, then "
        "point --ckpt_path here again.")
