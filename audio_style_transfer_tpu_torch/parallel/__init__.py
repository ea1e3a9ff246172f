"""Process groups, meshes and differentiable collectives over
torch.distributed (mesh.py), the exact long-form loss over several ranks or
on one device (halo.py) and the tensor-parallel decoder (tensor.py)."""

from audio_style_transfer_tpu_torch.parallel.mesh import (
    data_parallel_specs,
    make_hybrid_mesh,
    make_mesh,
)
from audio_style_transfer_tpu_torch.parallel.tensor import tp_decode_logits
