"""PyTorch/CUDA port of the audio style transfer system.

The counterpart of ``audio_style_transfer_tpu`` (the JAX reference, which
stays as it is) for one NVIDIA H100. Subpackage and module names follow the
JAX package so each module's counterpart is easy to find:

  signal/    mu-law codecs and the STFT regularizer
  ops/       conv1d, the trunk kernels (chain.py, encoder.py) and the gram
             kernel (gram.py), hand-written CUDA C++ under csrc/, built at
             first use (_build.py)
  models/    WaveNet AE encoder taps and the teacher-forced decoder
  ckpt/      weights carried across from the JAX package (.npz)
  transfer/  grams, losses, eager L-BFGS, the style-transfer engine and
             long-form transfer (chunked, and exact)
  parallel/  process groups and meshes over torch.distributed (mesh.py),
             the exact long-form window scan (halo.py)
  generate/  encoding and autoregressive synthesis (one CUDA-graphed
             decoder step per sample on the card)
  train/     the trainer (Adam, EMA, microbatches, checkpoints, data
             parallelism) and the optimizers
  data/      TFRecord codec and the NSynth batch pipeline (the C++ reader
             of the repository's csrc/, built by g++ at first use)
  analysis/  NMF, optimal transport, spectrogram and gram figures
  utils/     audio files and the run-directory names
  tools/     probes and profilers run by hand on the card
  cli/       the transfer, generate, save_embeddings and train CLIs

Layouts at the public functions match the JAX package: activations
[B, T, C], conv weights [F, Cin, Cout]. This package imports torch and never
jax.
"""

__version__ = "0.1.0"
