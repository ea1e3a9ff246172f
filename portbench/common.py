"""Small helpers shared by the drivers."""

from __future__ import annotations

import statistics
import time

import torch

from portbench.reference.nsynth import GEOMETRY_KEYS


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def clock() -> float:
    return time.perf_counter()


def model_config(cfg: dict, **changes):
    """The program's WaveNetAEConfig of a configuration file."""
    from audio_style_transfer_tpu_torch.models.wavenet_ae import WaveNetAEConfig

    return WaveNetAEConfig(**{k: cfg[k] for k in GEOMETRY_KEYS},
                           compute_dtype=getattr(torch, cfg["compute_dtype"]), **changes)


def rel_l2(got, want) -> float:
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return float(torch.linalg.vector_norm(got.to(want.device) - want)
                 / torch.linalg.vector_norm(want))


def rel_gap(got: float, want: float) -> float:
    return abs(float(got) - float(want)) / abs(float(want))


def worst_leaf_gap(got: dict, want: dict, keep=None) -> float:
    """max over leaves of |got - want| / max(want, median of want): the gap
    between two norms of each leaf, against the leaf's reference norm or the
    median leaf's, whichever is larger."""
    names = [k for k in want if keep is None or k in keep]
    median = statistics.median(want[k] for k in names)
    return max(abs(got[k] - want[k]) / max(want[k], median) for k in names)
