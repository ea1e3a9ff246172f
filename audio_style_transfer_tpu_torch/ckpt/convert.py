"""Weights for the port (counterpart of audio_style_transfer_tpu/ckpt/convert.py).

The pretrained NSynth weights ship as a TF1 ``model.ckpt-200000`` bundle
(reference nsynth/README.md:29-33) with variables named by scope:
``ae_dilatedconv_5/W`` [1, 3, 128, 128], ``cond_map_out1/biases`` [256], ...
``convert_tf1_checkpoint`` reads it with the port's own TF-free reader
(``ckpt/bundle_reader.py``): ``<layer>/W [1,F,Cin,Cout]`` becomes
``params[<layer>]['w'] [F,Cin,Cout]`` and ``<layer>/biases`` becomes
``['b']``, float32 torch tensors. The model's layer names equal the TF
scopes, so no mapping table can drift out of sync with the model code.

Unlike the JAX converter, a failure of the reader is not retried through
TensorFlow: the port runs where TensorFlow is not installed, and a retry
would hide a fault of the reader. Its error propagates.

``load_pretrained`` takes the reference's ``--ckpt_path`` unchanged: it
converts the bundle on first use and caches ``<ckpt>.npz``, the flat layout
of the JAX ``save_params`` (keys ``<layer>/w``, ``<layer>/b``), which this
module reads and writes with numpy alone; so weights cross between the two
packages either way.

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


def convert_tf1_checkpoint(checkpoint_path: str, strict: bool = True,
                           device: torch.device | str = "cpu") -> dict:
    """Convert a TF1 NSynth WaveNet checkpoint to the port's params.

    Args:
      checkpoint_path: path prefix of the TF checkpoint
        (e.g. ``.../wavenet-ckpt/model.ckpt-200000``).
      strict: require every model parameter to be present in the checkpoint.
      device: where the float32 tensors are put.

    Returns:
      params: {layer_name: {'w': [F, Cin, Cout], 'b': [Cout]}}
    """
    from audio_style_transfer_tpu_torch.ckpt.bundle_reader import BundleReader
    from audio_style_transfer_tpu_torch.models.wavenet_ae import WaveNetAEConfig, _conv_shapes

    reader = BundleReader(checkpoint_path)
    var_shapes = reader.get_variable_to_shape_map()
    params_np: dict = {}
    missing = []
    for name, (f, cin, cout) in _conv_shapes(WaveNetAEConfig()).items():
        w_key, b_key = f"{name}/W", f"{name}/biases"
        if w_key not in var_shapes or b_key not in var_shapes:
            missing.append(name)
            continue
        w = reader.get_tensor(w_key)
        b = reader.get_tensor(b_key)
        # TF stores conv1d kernels as [1, filter, in, out] (masked.py:136).
        if w.ndim == 4:
            assert w.shape[0] == 1, f"{w_key}: unexpected shape {w.shape}"
            w = w[0]
        assert w.shape == (f, cin, cout), (
            f"{w_key}: got {w.shape}, expected {(f, cin, cout)}"
        )
        assert b.shape == (cout,), f"{b_key}: got {b.shape}, expected ({cout},)"
        params_np[name] = {"w": w, "b": b}
    if missing and strict:
        raise KeyError(
            f"checkpoint {checkpoint_path} is missing variables for layers: "
            f"{missing[:8]}{'...' if len(missing) > 8 else ''}"
        )
    return params_from_numpy(params_np, device)


def load_pretrained(checkpoint_path: str, device: torch.device | str = "cpu") -> dict:
    """Pretrained weights from the reference's ``--ckpt_path`` argument:
    the sibling ``<ckpt>.npz`` if it exists, else a path ending in ``.npz``,
    else the TF1 bundle, converted and cached as ``<ckpt>.npz`` (the cache
    is skipped where the directory is read-only)."""
    npz_path = checkpoint_path + ".npz"
    if os.path.exists(npz_path):
        return load_params(npz_path, device)
    if os.path.exists(checkpoint_path) and checkpoint_path.endswith(".npz"):
        return load_params(checkpoint_path, device)
    params = convert_tf1_checkpoint(checkpoint_path, device=device)
    try:
        save_params(npz_path, params)
    except OSError:  # read-only checkpoint dir: skip the cache
        pass
    return params


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
