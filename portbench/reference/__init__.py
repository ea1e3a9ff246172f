"""Plain PyTorch references of what the benchmark's cells compute.

float32 with TF32 off, no hand-written kernel, no cache, nothing imported from
the program under test: ``nsynth`` (the WaveNet autoencoder's encoder trunk,
decoder and mu-law NLL), ``transfer`` (style-transfer targets and loss, per
clip and over one global window), ``train`` (three Adam + EMA steps of the
autoencoder) and ``lowp`` (the scaled fp8 rounding of the controls).
"""
