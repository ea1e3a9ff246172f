"""The hand-written kernels against their plain versions on the card.

CUDA kernels have no CPU mode, so every test here needs a GPU and skips
without one. Run them on the card with
    python -m pytest tests/test_torch_cuda.py -m cuda
Shapes are small but cover what the CPU tests cannot: clip edges between
flattened batch rows, a dilation as long as the clip, a T that is not a
multiple of the gram kernel's tiles, both dtypes, and the autograd wiring.
"""

import numpy as np
import pytest
import torch

from audio_style_transfer_tpu_torch.ops import _build, chain, gram

pytestmark = pytest.mark.cuda

# float32: the same products summed in other orders; bfloat16: one ulp of
# the output where an f32 sum lands on the other side of a rounding boundary.
TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 7, 256])
def test_trunk_layer_kernels_match_plain(dev, dtype, d):
    gen = torch.Generator(device=dev).manual_seed(d)
    c, clip = chain.WIDTH, 256
    x = torch.randn((3 * clip, c), generator=gen, device=dev).to(dtype)
    wd = (torch.randn((3, c, c), generator=gen, device=dev) * 0.05).to(dtype)
    wr = (torch.randn((c, c), generator=gen, device=dev) * 0.05).to(dtype)
    bd = torch.randn((c,), generator=gen, device=dev) * 0.1
    br = torch.randn((c,), generator=gen, device=dev) * 0.1
    out_p, m_p, im_p = chain.layer_fwd_plain(x, wd, bd, wr, br, d, clip, True)
    out_k, m_k, im_k = chain.layer_fwd(x, wd, bd, wr, br, d, clip, True)
    torch.cuda.synchronize()
    assert _rel(out_k, out_p) <= TOL[dtype]
    assert float((m_k != m_p).float().mean()) <= 1e-3
    assert torch.equal(im_k, im_p)

    dxn = torch.randn_like(x, dtype=torch.float32).to(dtype)
    dtap = torch.randn_like(x, dtype=torch.float32).to(dtype)
    for tap in (None, dtap):
        dx_p = chain.layer_bwd_plain(dxn, tap, m_p, im_p, wd, wr, d, clip)
        dx_k = chain.layer_bwd(dxn, tap, m_p, im_p, wd, wr, d, clip)
        torch.cuda.synchronize()
        assert _rel(dx_k, dx_p) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nl,tl", [(1, 300), (10, 1000), (16, 257), (32, 64)])
def test_gram_kernel_matches_plain(dev, dtype, nl, tl):
    gen = torch.Generator(device=dev).manual_seed(nl)
    taps = [torch.randn((2, tl, 64), generator=gen, device=dev).to(dtype) for _ in range(nl)]
    got = gram.pair_gram_fwd(*taps)
    torch.cuda.synchronize()
    want = gram.pair_gram_reference(*taps)
    assert _rel(got, want) <= 2e-5  # float32 products and sums either way


def test_trunk_autograd_on_card_matches_cpu(dev):
    rng = np.random.RandomState(0)
    c, dils, emit = chain.WIDTH, (1, 2, 64), (0, 2)
    arrs = [rng.randn(2, 128, c), rng.randn(3, 3, c, c) * 0.05, rng.randn(3, c) * 0.1,
            rng.randn(3, c, c) * 0.05, rng.randn(3, c) * 0.1]
    cts = [torch.tensor(rng.randn(2, 128, c), dtype=torch.float32) for _ in emit]
    grads = {}
    for where in ("cpu", dev):
        ts = [torch.tensor(a, dtype=torch.float32, device=where).requires_grad_(True)
              for a in arrs]
        taps = chain.fused_trunk(*ts, dils, emit)
        grads[str(where)] = torch.autograd.grad(taps, ts, [g.to(where) for g in cts])
    for g_card, g_cpu in zip(grads[str(dev)], grads["cpu"]):
        assert _rel(g_card.cpu(), g_cpu) <= 1e-4


def test_gram_backward_beyond_the_plain_range_raises_on_card(dev):
    taps = [torch.zeros((1, 128, 32), device=dev, requires_grad=True) for _ in range(16)]
    with pytest.raises(NotImplementedError, match="K6"):
        gram.pair_gram(*taps).sum().backward()


def test_launch_counters_count_kernel_calls(dev):
    _build.reset_launches()
    taps = [torch.ones((1, 64, 32), device=dev) for _ in range(2)]
    gram.pair_gram_fwd(*taps)
    gram.pair_gram_fwd(*[tp.cpu() for tp in taps])  # plain version: not counted
    assert _build.LAUNCHES["K5"] == 1
