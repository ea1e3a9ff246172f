"""Weights: the pretrained TF1 bundle, converted without TensorFlow, and
the JAX package's ``.npz``."""

from audio_style_transfer_tpu_torch.ckpt.convert import (
    convert_tf1_checkpoint,
    load_params,
    load_pretrained,
    save_params,
)
