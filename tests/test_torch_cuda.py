"""The hand-written kernels against their plain versions on the card.

CUDA kernels have no CPU mode, so every test here needs a GPU and skips
without one. Run them on the card with
    python -m pytest tests/test_torch_cuda.py -m cuda
Shapes are small but cover what the CPU tests cannot: clip edges between
flattened batch rows, a dilation as long as the clip, a T that is not a
multiple of the gram kernels' tiles, up to the 32 taps a gram launch takes,
both dtypes, both trunk flavours, and the autograd wiring.
"""

import numpy as np
import pytest
import torch

from audio_style_transfer_tpu_torch.ops import _build, chain, encoder, gram

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nl,tl", [(1, 257), (16, 1000), (30, 257), (30, 1000), (32, 257)])
def test_gram_backward_kernel_matches_plain(dev, dtype, nl, tl):
    gen = torch.Generator(device=dev).manual_seed(100 + nl)
    taps = [torch.randn((2, tl, 64), generator=gen, device=dev).to(dtype) for _ in range(nl)]
    h = torch.randn((2, nl, nl, 64), generator=gen, device=dev)
    got = gram.pair_gram_bwd(taps, h)
    torch.cuda.synchronize()
    want = gram.pair_gram_bwd_plain(taps, h)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert _rel(g, w) <= TOL[dtype]


def test_gram_autograd_beyond_the_plain_range_runs_the_kernel(dev):
    """L=16 > 15: the backward goes through K6 and matches the CPU."""
    rng = np.random.RandomState(1)
    arrs = [rng.randn(1, 300, 32).astype(np.float32) for _ in range(16)]
    ct = torch.tensor(rng.randn(1, 16, 16, 32), dtype=torch.float32)
    grads = {}
    for where in ("cpu", dev):
        taps = [torch.tensor(a, device=where).requires_grad_(True) for a in arrs]
        _build.reset_launches()
        grads[str(where)] = torch.autograd.grad(gram.pair_gram(*taps), taps, ct.to(where))
        assert _build.LAUNCHES["K6"] == (0 if where == "cpu" else 1)
    for g_card, g_cpu in zip(grads[str(dev)], grads["cpu"]):
        assert _rel(g_card.cpu(), g_cpu) <= 2e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 7, 256])
def test_encoder_block_kernels_match_plain(dev, dtype, d):
    """K7f / K7b on three flattened clips; d=256 reaches across whole clips."""
    gen = torch.Generator(device=dev).manual_seed(200 + d)
    c, clip = encoder.WIDTH, 256
    x = torch.randn((3 * clip, c), generator=gen, device=dev).to(dtype)
    wd = (torch.randn((3, c, c), generator=gen, device=dev) * 0.05).to(dtype)
    wr = (torch.randn((c, c), generator=gen, device=dev) * 0.05).to(dtype)
    bd = torch.randn((c,), generator=gen, device=dev) * 0.1
    br = torch.randn((c,), generator=gen, device=dev) * 0.1
    out_k = encoder.block_fwd(x, wd, bd, wr, br, d, clip)
    torch.cuda.synchronize()
    assert _rel(out_k, encoder.block_fwd_plain(x, wd, bd, wr, br, d, clip)) <= TOL[dtype]
    g = torch.randn((3 * clip, c), generator=gen, device=dev).to(dtype)
    dx_k = encoder.block_bwd(x, g, wd, bd, wr, d, clip)
    torch.cuda.synchronize()
    assert _rel(dx_k, encoder.block_bwd_plain(x, g, wd, bd, wr, d, clip)) <= TOL[dtype]


@pytest.mark.parametrize("flavour", ["chained", "per-layer"])
def test_full_stack_loss_and_gradient_on_card_match_cpu(dev, flavour):
    """18 layers of width 128, every tap a style tap (L=18 > 15: K6), float32,
    both trunk flavours: the card's loss and waveform gradient against the
    plain versions on the CPU."""
    from audio_style_transfer_tpu_torch.models.wavenet_ae import WaveNetAEConfig, init_params
    from audio_style_transfer_tpu_torch.transfer.losses import (
        LossSpec,
        transfer_embeds,
        transfer_loss,
    )

    cfg = WaveNetAEConfig(ae_num_layers=18, fused_encoder=flavour == "per-layer")
    spec = LossSpec(cont_lyr_ids=(17,), style_layer_ids=tuple(range(18)))
    params = init_params(0, cfg)
    rng = np.random.RandomState(3)
    xq = (np.sin(np.arange(4096) * 0.05) * 100 + rng.randn(4096) * 5).astype(np.float32)[None]
    other = (rng.randn(1, 4096) * 60).astype(np.float32)
    out = {}
    for where in ("cpu", dev):
        p = {k: {m: v.to(where) for m, v in e.items()} for k, e in params.items()
             if k.startswith("ae_")}
        with torch.no_grad():
            phi_c, phi_s = transfer_embeds(p, torch.tensor(other, device=where), cfg, spec)
        x = torch.tensor(xq[0], device=where).requires_grad_(True)
        _build.reset_launches()
        loss, _ = transfer_loss(p, x[None], phi_c, phi_s, cfg, spec)
        (g,) = torch.autograd.grad(loss, x)
        out[str(where)] = (float(loss.detach()), g.cpu(), dict(_build.LAUNCHES))
    (lc, gc, _), (lg, gg, launches) = out["cpu"], out[str(dev)]
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    assert float((gg - gc).norm() / gc.norm()) <= 5e-3
    kernels = ("K7f", "K7b") if flavour == "per-layer" else ("K1", "K2")
    assert all(launches[k] > 0 for k in kernels + ("K5", "K6")), launches


def test_launch_counters_count_kernel_calls(dev):
    _build.reset_launches()
    taps = [torch.ones((1, 64, 32), device=dev) for _ in range(2)]
    gram.pair_gram_fwd(*taps)
    gram.pair_gram_fwd(*[tp.cpu() for tp in taps])  # plain version: not counted
    h = torch.ones((1, 2, 2, 32), device=dev)
    gram.pair_gram_bwd(taps, h)
    gram.pair_gram_bwd([tp.cpu() for tp in taps], h.cpu())
    c = encoder.WIDTH
    x = torch.ones((64, c), device=dev)
    wd, w, b = torch.zeros((3, c, c), device=dev), torch.zeros((c, c), device=dev), x[0]
    encoder.block_fwd(x, wd, b, w, b, 1, 64)
    encoder.block_bwd(x, x, wd, b, w, 1, 64)
    encoder.block_fwd(x.cpu(), wd.cpu(), b.cpu(), w.cpu(), b.cpu(), 1, 64)
    assert {k: _build.LAUNCHES[k] for k in ("K5", "K6", "K7f", "K7b")} == {
        "K5": 1, "K6": 1, "K7f": 1, "K7b": 1}
