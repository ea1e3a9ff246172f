"""PyTorch/CUDA port of the audio style transfer system.

The counterpart of ``audio_style_transfer_tpu`` (the JAX reference, which
stays as it is) for one NVIDIA H100. Subpackage and module names follow the
JAX package so each module's counterpart is easy to find:

  signal/    mu-law codecs
  ops/       conv1d, the trunk kernels (chain.py) and the gram kernel
             (gram.py), hand-written CUDA C++ under csrc/, built at first
             use (_build.py)
  models/    WaveNet AE encoder taps and the teacher-forced decoder
  ckpt/      weights carried across from the JAX package (.npz)
  transfer/  grams, losses, eager L-BFGS, the style-transfer engine
  generate/  encoding and autoregressive synthesis (one CUDA-graphed
             decoder step per sample on the card)
  cli/       the transfer, generate and save_embeddings CLIs

Layouts at the public functions match the JAX package: activations
[B, T, C], conv weights [F, Cin, Cout]. This package imports torch and never
jax.
"""

__version__ = "0.1.0"
