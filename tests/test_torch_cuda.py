"""The hand-written kernels against their plain versions on the card.

CUDA kernels have no CPU mode, so every test here needs a GPU and skips
without one. Run them on the card with
    python -m pytest tests/test_torch_cuda.py -m cuda
Shapes are small but cover what the CPU tests cannot: clip edges between
flattened batch rows, a dilation as long as the clip, every tap bucket of the
gram kernels up to the 32 taps a launch takes at T = 1, a ragged T and the
main path's T, the inputs the wrappers refuse, both dtypes, both trunk
flavours, and the autograd wiring.
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


@pytest.mark.parametrize("transposed", [False, True])
def test_tensor_core_product_matches_matmul(dev, transposed):
    """One product through the bf16 kernels' staging (swizzled 16-byte chunks)
    and ldmatrix / mma fragments, both weight orientations, 300 rows (a short
    last tile), against torch.matmul in float32 on the same bf16 values."""
    gen = torch.Generator(device=dev).manual_seed(7)
    c = chain.WIDTH
    a = torch.randn((300, c), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn((c, c), generator=gen, device=dev).to(torch.bfloat16)
    got = chain.product_mma(a, w, transposed)
    torch.cuda.synchronize()
    wf = w.float().T if transposed else w.float()
    # The same 128 float32 products per output, summed in another order.
    assert _rel(got, a.float() @ wf) <= 2e-5


# Three flattened clips. clip 96: rows (288) no multiple of the 128-row tile
# and clip edges inside tiles; d >= clip: the outer taps read nothing;
# d = 128 and 512 at clip 1024: the three-tile form of the activation buffer.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("clip,d", [(256, 1), (256, 7), (256, 256), (96, 1), (96, 7), (96, 96),
                                    (96, 128), (1024, 128), (1024, 512)])
def test_trunk_layer_kernels_match_plain(dev, dtype, clip, d):
    gen = torch.Generator(device=dev).manual_seed(d)
    c = chain.WIDTH
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
    # The FMA kernels in the same dtype (for bfloat16 the other implementation).
    out_f, m_f, im_f = chain.layer_fwd_fma(x, wd, bd, wr, br, d, clip, True)
    torch.cuda.synchronize()
    assert _rel(out_k, out_f) <= TOL[dtype]
    assert float((m_k != m_f).float().mean()) <= 1e-3
    assert torch.equal(im_k, im_f)
    if dtype == torch.float32:
        assert torch.equal(out_k, out_f)  # float32 is the FMA kernel

    dxn = torch.randn_like(x, dtype=torch.float32).to(dtype)
    dtap = torch.randn_like(x, dtype=torch.float32).to(dtype)
    for tap in (None, dtap):
        dx_p = chain.layer_bwd_plain(dxn, tap, m_p, im_p, wd, wr, d, clip)
        dx_k = chain.layer_bwd(dxn, tap, m_p, im_p, wd, wr, d, clip)
        dx_f = chain.layer_bwd_fma(dxn, tap, m_p, im_p, wd, wr, d, clip)
        torch.cuda.synchronize()
        assert _rel(dx_k, dx_p) <= TOL[dtype]
        assert _rel(dx_k, dx_f) <= TOL[dtype]
        if dtype == torch.bfloat16:
            dy = chain.layer_bwd_mma_phase1(dxn, tap, m_p, wr, clip)
            dx_2 = chain.layer_bwd_mma_phase2(dxn, tap, dy, im_p, wd, d, clip)
            torch.cuda.synchronize()
            assert torch.equal(dx_2, dx_k)  # the phases alone are the same launches


def test_trunk_kernels_choose_by_dtype_and_count(dev):
    """bfloat16 and float32 both count under K1 / K2; a CPU tensor runs the
    plain version and counts nothing; float64 is refused."""
    c = chain.WIDTH
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.ones((64, c), device=dev, dtype=dtype)
        wd, w = torch.zeros((3, c, c), device=dev, dtype=dtype), torch.zeros((c, c), device=dev,
                                                                             dtype=dtype)
        b = torch.zeros((c,), device=dev)
        _build.reset_launches()
        out, m, im = chain.layer_fwd(x, wd, b, w, b, 1, 64, True)
        chain.layer_bwd(x, None, m, im, wd, w, 1, 64)
        chain.layer_fwd(x.cpu(), wd.cpu(), b.cpu(), w.cpu(), b.cpu(), 1, 64)
        torch.cuda.synchronize()
        assert torch.equal(out, x) and int(m.min()) == 1 and int(im.min()) == 1
        assert _build.LAUNCHES["K1"] == 1 and _build.LAUNCHES["K2"] == 1
        with pytest.raises(TypeError):
            chain.layer_fwd(x.double(), wd, b, w, b, 1, 64)
    with pytest.raises(TypeError):
        chain.product_mma(torch.ones((64, c), device=dev), w, False)


# Tap counts either side of every bucket the gram kernels are compiled for
# (8, 16, 24, 32), the main path's 10 and 30; one row, a T that ends inside
# a step, and the main path's T plus 8 rows; two clips; the narrowest C both
# kernels take and the model's.
GRAM_L = [1, 2, 8, 9, 10, 16, 17, 30, 32]
GRAM_T = [1, 1000, 16384 + 8]
GRAM_C = [32, 128]


def _gram_taps(dev, dtype, nl, tl, c, seed, b=2):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return gen, [torch.randn((b, tl, c), generator=gen, device=dev).to(dtype) for _ in range(nl)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", GRAM_C)
@pytest.mark.parametrize("tl", GRAM_T)
@pytest.mark.parametrize("nl", GRAM_L)
def test_gram_kernel_matches_plain(dev, dtype, nl, tl, c):
    _, taps = _gram_taps(dev, dtype, nl, tl, c, nl)
    got = gram.pair_gram_fwd(*taps)
    again = gram.pair_gram_fwd(*taps)
    torch.cuda.synchronize()
    want = gram.pair_gram_reference(*taps)
    assert got.shape == (2, nl, nl, c) and got.dtype == torch.float32
    assert _rel(got, want) <= 2e-5  # float32 products and sums either way
    assert torch.equal(got, again)  # a fixed summation order: no atomics
    assert torch.equal(got, got.transpose(1, 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gram_kernels_refuse_what_they_do_not_take(dev, dtype):
    _, taps = _gram_taps(dev, dtype, 3, 64, 32, 0)
    h = torch.zeros((2, 3, 3, 32), device=dev)
    # Contiguous, but one element off the 16-byte grid the loads need.
    flat = torch.zeros((2 * 64 * 32 + 1,), device=dev, dtype=dtype)
    shifted = flat[1:].view(2, 64, 32)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    strided = torch.zeros((2, 32, 64), device=dev, dtype=dtype).transpose(1, 2)
    narrow = [tp[:, :, :24].contiguous() for tp in taps]
    _build.reset_launches()
    for bad, match in ((shifted, "aligned"), (strided, "contiguous")):
        with pytest.raises(ValueError, match=match):
            gram.pair_gram_fwd(taps[0], bad, taps[2])
        with pytest.raises(ValueError, match=match):
            gram.pair_gram_bwd([taps[0], bad, taps[2]], h)
    with pytest.raises(ValueError, match="multiple of 8"):
        gram.pair_gram_fwd(*[tp[:, :, :20].contiguous() for tp in taps])
    with pytest.raises(ValueError, match="multiple of 16"):
        gram.pair_gram_bwd(narrow, h[..., :24].contiguous())
    with pytest.raises(ValueError, match="h must be"):
        gram.pair_gram_bwd(taps, h.transpose(1, 2)[:, :, :2])
    with pytest.raises(ValueError, match="1..32 taps"):
        gram.pair_gram_fwd(*(taps * 11))
    with pytest.raises(TypeError):
        gram.pair_gram_fwd(*[tp.double() for tp in taps])
    assert not any(_build.LAUNCHES.values())


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
@pytest.mark.parametrize("c", GRAM_C)
@pytest.mark.parametrize("tl", GRAM_T)
@pytest.mark.parametrize("nl", GRAM_L)
def test_gram_backward_kernel_matches_plain(dev, dtype, nl, tl, c):
    gen, taps = _gram_taps(dev, dtype, nl, tl, c, 100 + nl)
    h = torch.randn((2, nl, nl, c), generator=gen, device=dev)  # not symmetric
    got = gram.pair_gram_bwd(taps, h)
    torch.cuda.synchronize()
    want = gram.pair_gram_bwd_plain(taps, h)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert _rel(g, w) <= TOL[dtype]


@pytest.mark.parametrize("nl", [10, 16])
def test_gram_autograd_on_the_card_runs_the_backward_kernel_at_any_l(dev, nl):
    """L=10 (the stack-0 tap count) and L=16: the backward of CUDA taps is one
    K6 launch and matches the CPU's plain composition."""
    rng = np.random.RandomState(1)
    arrs = [rng.randn(1, 300, 32).astype(np.float32) for _ in range(nl)]
    ct = torch.tensor(rng.randn(1, nl, nl, 32), dtype=torch.float32)
    grads = {}
    for where in ("cpu", dev):
        taps = [torch.tensor(a, device=where).requires_grad_(True) for a in arrs]
        _build.reset_launches()
        grads[str(where)] = torch.autograd.grad(gram.pair_gram(*taps), taps, ct.to(where))
        on_card = int(where != "cpu")
        assert _build.LAUNCHES["K5"] == on_card and _build.LAUNCHES["K6"] == on_card
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


def _wf_inputs(dev, dtype, dils, rows, missing=(), seed=0):
    gen = torch.Generator(device=dev).manual_seed(300 + seed)
    c, k = chain.WIDTH, len(dils)
    rand = lambda *shape: torch.randn(shape, generator=gen, device=dev)  # noqa: E731
    wd, wr = (rand(k, 3, c, c) * 0.05).to(dtype), (rand(k, c, c) * 0.05).to(dtype)
    dxn = rand(rows, c).to(dtype)
    dtaps = [None if j in missing else rand(rows, c).to(dtype) for j in range(k)]
    masks = [torch.randint(0, 4, (rows, c), generator=gen, device=dev, dtype=torch.uint8)
             for _ in range(k)]
    inmask = torch.randint(0, 2, (rows, c), generator=gen, device=dev, dtype=torch.uint8)
    return dxn, dtaps, masks, inmask, wd, wr


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dils,missing", [((1, 2, 4, 8), ()), ((1, 2, 4, 8), (0, 2)),
                                          ((1, 2, 4), (1,)), ((2, 4), ()), ((8, 4, 2, 1), ())])
def test_wavefront_group_kernel_matches_plain_and_the_k2_chain(dev, dtype, dils, missing):
    """K2-wf on three flattened clips of 256 rows (halos cross clip edges):
    against its plain version at the trunk tolerances, bit for bit against
    the single-layer FMA K2 launches built on the same code (same products,
    same order per row), and against the K2 launches ``layer_bwd`` makes:
    bit for bit in float32, at the tolerance in bfloat16 (tensor cores)."""
    clip = 256
    args = _wf_inputs(dev, dtype, dils, 3 * clip, missing)
    group = chain.plan_bwd_groups(dils, clip, args[0].element_size())[0]
    assert group.splits is not None and len(group.dils) == len(dils)
    _build.reset_launches()
    got = chain.group_bwd(*args, group, clip)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["K2wf"] == 1 and _build.LAUNCHES["K2"] == 0
    want = chain.group_bwd_plain(*args, dils, clip, group.tile, group.splits)
    assert got.dtype == dtype and _rel(got, want) <= TOL[dtype]
    dxn, dtaps, masks, inmask, wd, wr = args
    chains = {}
    for layer in (chain.layer_bwd_fma, chain.layer_bwd):
        dx = dxn
        for j in range(len(dils) - 1, -1, -1):
            dx = layer(dx, dtaps[j], masks[j], masks[j - 1] if j else inmask,
                       wd[j], wr[j], dils[j], clip)
        chains[layer] = dx
    torch.cuda.synchronize()
    assert torch.equal(got, chains[chain.layer_bwd_fma])
    if dtype == torch.float32:
        assert torch.equal(got, chains[chain.layer_bwd])
    else:
        assert _rel(got, chains[chain.layer_bwd]) <= TOL[dtype]


def test_wavefront_group_kernel_refuses_what_it_does_not_take(dev):
    dils, clip = (1, 2, 4, 8), 256
    args = _wf_inputs(dev, torch.float32, dils, clip)
    good = chain.plan_bwd_groups(dils, clip, 4)[0]
    assert good.tile == 32
    # float32 at tile 64: three carry slots do not fit a block's shared memory.
    big = chain.BwdGroup(0, dils, 64, chain.wavefront_splits(dils, 64))
    with pytest.raises(ValueError, match="shared memory"):
        chain.group_bwd(*args, big, clip)
    # Splits that do not recede by d: the C entry point returns invalid value.
    bad = chain.BwdGroup(0, dils, 32, tuple(s + 1 for s in good.splits[:-1]) + good.splits[-1:])
    with pytest.raises(RuntimeError, match="ast_trunk_bwd_group"):
        chain.group_bwd(*args, bad, clip)
    with pytest.raises(TypeError):
        chain.group_bwd(args[0].double(), *args[1:], good, clip)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_trunk_backward_with_the_wavefront_switch_on_card(dev, dtype, monkeypatch):
    """dils (1, 2, 4, 8, 64): with the switch on the backward is one K2-wf
    launch and one K2 launch. It equals the five K2 launches bit for bit where
    K2 is the FMA kernel K2-wf is built on (float32; bfloat16 with
    ``layer_bwd_fma`` in ``layer_bwd``'s place), and at the tolerance against
    the tensor-core K2 in bfloat16."""
    rng = np.random.RandomState(5)
    c, dils, emit = chain.WIDTH, (1, 2, 4, 8, 64), (1, 3, 4)
    arrs = [rng.randn(2, 256, c), rng.randn(5, 3, c, c) * 0.05, rng.randn(5, c) * 0.1,
            rng.randn(5, c, c) * 0.05, rng.randn(5, c) * 0.1]
    cts = [torch.tensor(rng.randn(2, 256, c), dtype=torch.float32, device=dev).to(dtype)
           for _ in emit]
    grads = {}
    for fma in (False, True):
        if fma:
            monkeypatch.setattr(chain, "layer_bwd", chain.layer_bwd_fma)
        for on in (False, True):
            monkeypatch.setattr(chain, "_BWD_WAVEFRONT", on)
            ts = [torch.tensor(a, dtype=torch.float32, device=dev).to(dtype) for a in arrs]
            ts[0].requires_grad_(True)
            _build.reset_launches()
            taps = chain.fused_trunk(*ts, dils, emit)
            (grads[fma, on],) = torch.autograd.grad(taps, ts[0], cts)
            torch.cuda.synchronize()
            want = {"K1": 5, "K2": 1, "K2wf": 1} if on else {"K1": 5, "K2": 5, "K2wf": 0}
            assert {k: _build.LAUNCHES[k] for k in want} == want
    assert torch.equal(grads[True, True], grads[True, False])
    if dtype == torch.float32:
        assert torch.equal(grads[False, True], grads[False, False])
    else:
        assert _rel(grads[False, True], grads[False, False]) <= TOL[dtype]


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
