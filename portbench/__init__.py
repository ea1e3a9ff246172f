"""The benchmark of the PyTorch/CUDA port (``audio_style_transfer_tpu_torch``).

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
from the root of a checkout; BENCHMARK.json at the root names the cells.
Nothing here imports JAX or the JAX package, and ``reference/`` imports
nothing of the program under test.
"""
