"""Weights carried across from the JAX package (counterpart of
audio_style_transfer_tpu/ckpt/convert.py).

The JAX ``save_params`` writes a flat ``.npz`` with keys ``<layer>/w``
([F, Cin, Cout]) and ``<layer>/b``; this module reads it with numpy alone
and returns torch tensors, and writes the same layout (``save_params``), so
weights trained in the port load into the JAX package and the port's CLIs. Converting the pretrained TF1 bundle stays with
the JAX package's converter, which writes that ``.npz``.

The baseline spectral AE's weights cross as the JAX pytree in numpy
(``baseline_params_from_numpy`` / ``baseline_params_to_numpy``).
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


def save_params(path: str, params: dict) -> None:
    """Write params as the flat ``.npz`` of the JAX ``save_params`` (keys
    ``<layer>/w``, ``<layer>/b``; float32 arrays as they are held)."""
    flat = {f"{layer}/{k}": v.detach().cpu().numpy()
            for layer, entry in params.items() for k, v in entry.items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


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


def _baseline_w_to_torch(w: np.ndarray, transpose: bool) -> np.ndarray:
    """A JAX HWIO conv kernel in the port's layout: OIHW, or for a
    transposed conv the kernel flipped in both spatial axes as [I, O, kh, kw]
    (models/baseline_ae.py::_conv2d_transpose)."""
    if transpose:
        return np.transpose(w[::-1, ::-1], (2, 3, 0, 1)).copy()
    return np.transpose(w, (3, 2, 0, 1)).copy()


def _baseline_w_to_jax(w: np.ndarray, transpose: bool) -> np.ndarray:
    if transpose:
        return np.transpose(w, (2, 3, 0, 1))[::-1, ::-1].copy()
    return np.transpose(w, (2, 3, 1, 0)).copy()


def _baseline_entries(tree: dict):
    """(state_dict prefix, JAX entry, transposed conv?) of a baseline pytree
    {encoder: [..], z_proj, decoder: [..], mag_out, pitch_embedding}."""
    for i, e in enumerate(tree["encoder"]):
        yield f"encoder.{i}", e, False
    yield "z_proj", tree["z_proj"], False
    for i, e in enumerate(tree["decoder"]):
        yield f"decoder.{i}", e, True
    yield "mag_out", tree["mag_out"], False
    yield "pitch_embedding", tree["pitch_embedding"], False


def baseline_params_from_numpy(tree: dict, device: torch.device | str = "cpu") -> dict:
    """The JAX baseline AE's params pytree (numpy arrays: HWIO convs, the
    ``bn_*`` entries, ``z_proj``, ``mag_out``, ``pitch_embedding``) -> the
    port's ``BaselineAE`` state_dict (parameters and BN buffers), float32 on
    ``device``: ``model.load_state_dict(baseline_params_from_numpy(tree))``."""
    out = {}
    for prefix, entry, transpose in _baseline_entries(tree):
        for k, v in entry.items():
            v = np.asarray(v, np.float32)
            if k == "w" and prefix != "pitch_embedding":
                v = _baseline_w_to_torch(v, transpose)
            out[f"{prefix}.{k}"] = torch.tensor(v, device=device)
    return out


def baseline_params_to_numpy(state_dict: dict) -> dict:
    """The inverse: a ``BaselineAE`` state_dict -> the JAX pytree in numpy."""
    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    n_enc = len({k.split(".")[1] for k in sd if k.startswith("encoder.")})
    n_dec = len({k.split(".")[1] for k in sd if k.startswith("decoder.")})
    tree = {"encoder": [{} for _ in range(n_enc)], "decoder": [{} for _ in range(n_dec)],
            "z_proj": {}, "mag_out": {}, "pitch_embedding": {}}
    for prefix, entry, transpose in _baseline_entries(tree):
        for key, v in sd.items():
            if key.rsplit(".", 1)[0] != prefix:
                continue
            k = key.rsplit(".", 1)[1]
            if k == "w" and prefix != "pitch_embedding":
                v = _baseline_w_to_jax(v, transpose)
            entry[k] = v
    return tree
