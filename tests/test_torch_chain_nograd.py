"""The gradient-free trunk pass (ops/chain.py ``trunk_forward(keep=)``, taken
by ``fused_trunk`` when nothing needs a gradient) keeps the emitted taps and
nothing else, and its taps equal those of the pass that keeps everything for
a backward, bit for bit. On the CPU the wrappers run K1's plain version;
the launches are the same either way (one K1 per layer on a CUDA tensor).
"""

import numpy as np
import pytest
import torch
from torch_helpers import t, trunk_inputs

from audio_style_transfer_tpu_torch.ops import chain

DILS = (1, 2, 4, 8, 256)


@pytest.mark.parametrize("emit", [(4,), (1, 3, 4), (0, 1, 2, 3, 4)])
@pytest.mark.parametrize("window", [None, (37, 400)])
def test_taps_without_grad_equal_taps_with_grad(emit, window):
    x, wd, bd, wr, br = trunk_inputs()
    w = [t(a) for a in (wd, bd, wr, br)]
    with torch.no_grad():
        free = chain.fused_trunk(t(x)[None], *w, DILS, emit, valid_window=window)
    xt = t(x)[None].requires_grad_(True)
    kept = chain.fused_trunk(xt, *w, DILS, emit, valid_window=window)
    assert kept[0].grad_fn is not None and free[0].grad_fn is None
    assert len(free) == len(kept) == len(emit)
    for a, b in zip(free, kept):
        assert torch.equal(a, b.detach())


def test_no_input_needing_a_gradient_takes_the_gradient_free_pass():
    """Grad mode on, but neither x nor a weight needs a gradient."""
    x, wd, bd, wr, br = trunk_inputs()
    (tap,) = chain.fused_trunk(t(x)[None], *(t(a) for a in (wd, bd, wr, br)), DILS, (4,))
    assert tap.grad_fn is None and not tap.requires_grad


def test_gradient_free_pass_keeps_only_the_emitted_layers():
    x, wd, bd, wr, br = trunk_inputs()
    w = [t(a) for a in (wd, bd, wr, br)]
    outs, masks, inmask = chain.trunk_forward(t(x), *w, DILS, x.shape[0], keep={1, 4})
    assert [o is not None for o in outs] == [False, True, False, False, True]
    assert masks == [] and inmask is None
    full, full_masks, full_inmask = chain.trunk_forward(t(x), *w, DILS, x.shape[0])
    assert len(full_masks) == len(DILS) and full_inmask is not None
    for j in (1, 4):
        assert torch.equal(outs[j], full[j])


def test_gradient_through_the_weights_still_takes_the_autograd_pass():
    """A weight that needs a gradient (the recompute path) is not gradient-free."""
    x, wd, bd, wr, br = trunk_inputs()
    wdt = t(wd).requires_grad_(True)
    (tap,) = chain.fused_trunk(t(x)[None], wdt, t(bd), t(wr), t(br), DILS, (4,))
    (g,) = torch.autograd.grad(tap.sum(), wdt)
    assert g.shape == wdt.shape and np.isfinite(g.numpy()).all()
