"""Process groups and meshes over torch.distributed (mesh.py), and the exact
long-form windows on one device (halo.py; its sharded half and
``tp_decode_logits`` are ROADMAP.md M8b)."""

from audio_style_transfer_tpu_torch.parallel.mesh import (
    data_parallel_specs,
    make_hybrid_mesh,
    make_mesh,
)
