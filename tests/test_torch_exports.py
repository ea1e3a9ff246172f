"""Each subpackage of the port exports the public names its JAX
counterpart's ``__init__.py`` re-exports (so ``from
audio_style_transfer_tpu_torch.models import init_params`` works as the JAX
form does); and ``encoder_features``, one of those names, against JAX.
"""

import ast
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import TOY, jax_params_np, torch_params

from audio_style_transfer_tpu.models import wavenet_ae as jw
from audio_style_transfer_tpu_torch.models import wavenet_ae as tw

JAX_PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "audio_style_transfer_tpu")
SUBPACKAGES = ("analysis", "ckpt", "data", "generate", "models", "ops", "parallel", "signal",
               "train", "transfer", "utils")


def _jax_exports(sub: str) -> list[str]:
    """The names the JAX subpackage's __init__.py imports, read from its
    source (nothing of JAX is imported for it)."""
    with open(os.path.join(JAX_PKG, sub, "__init__.py")) as f:
        tree = ast.parse(f.read())
    return [a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom)
            for a in node.names]


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_port_subpackage_exports_what_jax_does(sub):
    port = importlib.import_module(f"audio_style_transfer_tpu_torch.{sub}")
    names = _jax_exports(sub)
    assert names, sub
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, f"{sub} lacks {missing}"


def test_encoder_features_matches_jax():
    """The dict of taps, encoding and before_enc, at rel 1e-5 (the slice
    tests' tolerance)."""
    pnp = jax_params_np(0, **TOY)
    xq = np.random.RandomState(0).uniform(-128, 127, (1, 1024)).astype(np.float32)
    want = jw.encoder_features(jax.tree.map(jnp.asarray, pnp), jnp.asarray(xq),
                               jw.WaveNetAEConfig(**TOY))
    got = tw.encoder_features(torch_params(pnp), torch.tensor(xq), tw.WaveNetAEConfig(**TOY))
    assert got.keys() == want.keys()
    assert len(got["extracts"]) == len(want["extracts"])
    for key in ("encoding", "before_enc"):
        w, g = np.asarray(want[key]), got[key].detach().numpy()
        assert g.shape == w.shape
        assert float(np.abs(g - w).max()) <= 1e-5 * float(np.abs(w).max()), key
