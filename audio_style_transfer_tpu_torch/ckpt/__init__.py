"""Weights as the JAX package's ``.npz``. The TF1 checkpoint reader
(``convert_tf1_checkpoint``) stays with the JAX converter."""

from audio_style_transfer_tpu_torch.ckpt.convert import (
    load_params,
    load_pretrained,
    save_params,
)
