"""The hand-written kernels against their plain versions on the card.

CUDA kernels have no CPU mode, so every test here needs a GPU and skips
without one. Run them on the card with
    python -m pytest tests/test_torch_cuda.py -m cuda
Shapes are small but cover what the CPU tests cannot: clip edges between
flattened batch rows, a dilation as long as the clip, every tap bucket of the
gram kernels up to the 32 taps a launch takes at T = 1, a ragged T and the
main path's T, the inputs the wrappers refuse, both dtypes, both trunk
flavours, valid windows, and the autograd wiring.
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

    dxn = torch.randn_like(x, dtype=torch.float32).to(dtype)
    dtap = torch.randn_like(x, dtype=torch.float32).to(dtype)
    for tap in (None, dtap):
        dx_p = chain.layer_bwd_plain(dxn, tap, m_p, im_p, wd, wr, d, clip)
        dx_k = chain.layer_bwd(dxn, tap, m_p, im_p, wd, wr, d, clip)
        torch.cuda.synchronize()
        assert _rel(dx_k, dx_p) <= TOL[dtype]


# Valid windows of the exact long-form scan, in in-clip rows: both edges
# inside 128-row tiles, from 0, to the end, empty, clamped, one row; at the
# engine's T and at the scan's extended window (32768 + 2 * 4096 rows, no
# multiple of 16384), with a dilation on either side of the tile size.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(16384, 1), (16384, 512), (40960, 4), (40960, 256)])
def test_windowed_trunk_kernels_match_plain(dev, dtype, rows, d):
    gen = torch.Generator(device=dev).manual_seed(d)
    c = chain.WIDTH
    x = torch.randn((rows, c), generator=gen, device=dev).to(dtype)
    wd = (torch.randn((3, c, c), generator=gen, device=dev) * 0.05).to(dtype)
    wr = (torch.randn((c, c), generator=gen, device=dev) * 0.05).to(dtype)
    bd = torch.randn((c,), generator=gen, device=dev) * 0.1
    br = torch.randn((c,), generator=gen, device=dev) * 0.1
    dxn = torch.randn_like(x, dtype=torch.float32).to(dtype)
    dtap = torch.randn_like(x, dtype=torch.float32).to(dtype)
    base = chain.layer_fwd(x, wd, bd, wr, br, d, rows, True)
    for vw in [(4096 + 37, rows - 4096 - 61), (0, 1000), (rows - 200, rows), (300, 300),
               (-50, rows + 50), (777, 778)]:
        lo, hi = max(vw[0], 0), min(vw[1], rows)
        out_p, m_p, im_p = chain.layer_fwd_plain(x, wd, bd, wr, br, d, rows, True, vw)
        out_k, m_k, im_k = chain.layer_fwd(x, wd, bd, wr, br, d, rows, True, vw)
        torch.cuda.synchronize()
        assert _rel(out_k, out_p) <= TOL[dtype]
        assert float((m_k != m_p).float().mean()) <= 1e-3
        assert torch.equal(im_k, im_p)
        # Masked rows: zero output, zero bit 0, the gate bit as without a window.
        for part in (slice(0, lo), slice(hi, rows)):
            assert not out_k[part].any() and not (m_k[part] & 1).any()
            assert torch.equal(m_k[part] >> 1, base[1][part] >> 1)
        assert torch.equal(out_k[lo:hi], base[0][lo:hi])
        if (lo, hi) == (0, rows):  # the full range is the unwindowed kernel bit for bit
            assert torch.equal(out_k, base[0]) and torch.equal(m_k, base[1])
        for tap in (None, dtap):
            dx_p = chain.layer_bwd_plain(dxn, tap, m_p, im_p, wd, wr, d, rows, vw)
            dx_k = chain.layer_bwd(dxn, tap, m_p, im_p, wd, wr, d, rows, vw)
            torch.cuda.synchronize()
            assert _rel(dx_k, dx_p) <= TOL[dtype]
            if (lo, hi) == (0, rows):
                assert torch.equal(dx_k, chain.layer_bwd(dxn, tap, m_p, im_p, wd, wr, d, rows))


# The bf16 K1/K2 walk 64-row tiles, two warpgroups a block, one block an SM
# at most: the transfer cells' one clip of 237 568 rows, training's 32 clips
# of 6 144, a ragged count past a tile (237 568 + 77) and fewer rows than a
# tile (40); dilations on both sides of the tile and one past the clip.
@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("d", [1, 64, 128, 512, "past the clip"])
@pytest.mark.parametrize("rows,clip", [(237568, 237568), (32 * 6144, 6144),
                                       (237568 + 77, 237568 + 77), (40, 40)])
def test_tensor_core_trunk_kernels_at_the_cells_shapes(dev, rows, clip, d, windowed):
    """K1 and K2 (with and without a tap cotangent) against their plain
    versions; with a window, zero outside it in every clip."""
    d = clip + 1 if d == "past the clip" else d
    vw = ((5, 33) if clip < 4096 else (100, clip - 144) if clip < 16384
          else (4096 + 37, clip - 4096 - 61)) if windowed else None
    x, wd, bd, wr, br, dxn = _block_inputs(dev, torch.bfloat16, rows, rows % 1000 + d % 997)
    out_p, m_p, im_p = chain.layer_fwd_plain(x, wd, bd, wr, br, d, clip, True, vw)
    out_k, m_k, im_k = chain.layer_fwd(x, wd, bd, wr, br, d, clip, True, vw)
    torch.cuda.synchronize()
    assert _rel(out_k, out_p) <= TOL[x.dtype]
    assert float((m_k != m_p).float().mean()) <= 1e-3
    assert torch.equal(im_k, im_p)
    if vw is not None:
        pos = torch.arange(rows, device=dev) % clip
        outside = (pos < vw[0]) | (pos >= vw[1])
        assert not out_k[outside].any() and not (m_k[outside] & 1).any()
    del out_p, out_k, m_k, im_k
    for tap in (None, x):
        dx_p = chain.layer_bwd_plain(dxn, tap, m_p, im_p, wd, wr, d, clip, vw)
        dx_k = chain.layer_bwd(dxn, tap, m_p, im_p, wd, wr, d, clip, vw)
        torch.cuda.synchronize()
        assert _rel(dx_k, dx_p) <= TOL[x.dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_windowed_trunk_takes_the_window_per_clip(dev, dtype):
    """Three flattened clips of 96 rows (clip edges and window edges inside
    one tile): the window is in in-clip rows."""
    gen = torch.Generator(device=dev).manual_seed(5)
    c, clip, vw = chain.WIDTH, 96, (10, 70)
    x = torch.randn((3 * clip, c), generator=gen, device=dev).to(dtype)
    wd = (torch.randn((3, c, c), generator=gen, device=dev) * 0.05).to(dtype)
    wr = (torch.randn((c, c), generator=gen, device=dev) * 0.05).to(dtype)
    b = torch.randn((c,), generator=gen, device=dev) * 0.1
    out_p, m_p, im_p = chain.layer_fwd_plain(x, wd, b, wr, b, 7, clip, True, vw)
    out_k, m_k, _ = chain.layer_fwd(x, wd, b, wr, b, 7, clip, True, vw)
    dxn = torch.randn_like(x, dtype=torch.float32).to(dtype)
    dx_p = chain.layer_bwd_plain(dxn, dxn, m_p, im_p, wd, wr, 7, clip, vw)
    dx_k = chain.layer_bwd(dxn, dxn, m_p, im_p, wd, wr, 7, clip, vw)
    torch.cuda.synchronize()
    assert _rel(out_k, out_p) <= TOL[dtype] and _rel(dx_k, dx_p) <= TOL[dtype]
    assert float((m_k != m_p).float().mean()) <= 1e-3
    for k in range(3):
        assert not out_k[k * clip:k * clip + 10].any()
        assert not out_k[k * clip + 70:(k + 1) * clip].any()


def test_kernels_at_the_rows_of_a_60_s_single_window(dev):
    """958 464 rows (60 s trimmed to 4096): every index product of the trunk
    and gram kernels at the longest clip the single-window exact mode takes by
    default is far past 2^27 elements; bfloat16, one layer and 10 taps."""
    gen = torch.Generator(device=dev).manual_seed(3)
    c, rows, d, dt = chain.WIDTH, 958464, 512, torch.bfloat16
    x = torch.randn((rows, c), generator=gen, device=dev).to(dt)
    wd = (torch.randn((3, c, c), generator=gen, device=dev) * 0.05).to(dt)
    wr = (torch.randn((c, c), generator=gen, device=dev) * 0.05).to(dt)
    b = torch.randn((c,), generator=gen, device=dev) * 0.1
    vw = (4096, rows - 5000)
    out_p, m_p, im_p = chain.layer_fwd_plain(x, wd, b, wr, b, d, rows, True, vw)
    out_k, m_k, im_k = chain.layer_fwd(x, wd, b, wr, b, d, rows, True, vw)
    torch.cuda.synchronize()
    assert _rel(out_k, out_p) <= TOL[dt] and torch.equal(im_k, im_p)
    assert float((m_k != m_p).float().mean()) <= 1e-3
    assert not out_k[rows - 5000:].any() and out_k[rows - 5001].any()
    dx_p = chain.layer_bwd_plain(x, out_p, m_p, im_p, wd, wr, d, rows, vw)
    dx_k = chain.layer_bwd(x, out_p, m_p, im_p, wd, wr, d, rows, vw)
    torch.cuda.synchronize()
    assert _rel(dx_k, dx_p) <= TOL[dt]
    del out_k, m_k, im_k, dx_p, dx_k
    taps = [torch.roll(x, k, 0)[None] * (0.5 + 0.1 * k) for k in range(10)]
    got = gram.pair_gram_fwd(*taps)
    torch.cuda.synchronize()
    # Sums of 958 464 products: float32 in another order, 1e-4 of the largest.
    assert _rel(got, gram.pair_gram_reference(*taps)) <= 1e-4
    h = torch.randn((1, 10, 10, c), generator=gen, device=dev)
    outs = gram.pair_gram_bwd(taps, h)
    want = gram.pair_gram_bwd_plain(taps, h)
    torch.cuda.synchronize()
    assert max(_rel(o, w) for o, w in zip(outs, want)) <= TOL[dt]


def test_windowed_fused_trunk_gradient_on_the_card(dev):
    """autograd through the windowed trunk on the card (K1, then K2) against
    the plain versions on the CPU, float32, five layers."""
    gen = torch.Generator().manual_seed(9)
    c, rows, dils, vw = chain.WIDTH, 2048, (1, 2, 64, 128, 512), (300, 1700)
    x = torch.randn((rows, c), generator=gen)
    wd = torch.randn((5, 3, c, c), generator=gen) * 0.05
    wr = torch.randn((5, c, c), generator=gen) * 0.05
    bd, br = torch.randn((5, c), generator=gen) * 0.1, torch.randn((5, c), generator=gen) * 0.1
    ct = torch.randn((rows, c), generator=gen)
    grads = {}
    for where in ("cpu", dev):
        xt = x.to(where).requires_grad_(True)
        _build.reset_launches()
        taps = chain.fused_trunk(xt, *(a.to(where) for a in (wd, bd, wr, br)), dils, (1, 4),
                                 valid_window=vw)
        (g,) = torch.autograd.grad(taps, xt, [ct.to(where)] * 2)
        grads[str(where)] = g.cpu()
        want = 5 if where != "cpu" else 0
        assert _build.LAUNCHES["K1"] == want and _build.LAUNCHES["K2"] == want
    rel = float((grads[str(dev)] - grads["cpu"]).norm() / grads["cpu"].norm())
    assert rel <= 5e-3, rel  # a relu gate near zero may flip between the two paths


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


# Tap counts either side of every bucket the gram kernels are compiled for
# (8, 16, 24, 32), the main path's 10 and 30; one row, a T that ends inside
# a step, and the main path's T plus 8 rows; two clips; the narrowest C both
# kernels take and the model's; K5 also at a C that is an odd multiple of 8
# (the bf16 kernel masks the rest of its 64-channel group).
GRAM_L = [1, 2, 8, 9, 10, 16, 17, 30, 32]
GRAM_T = [1, 1000, 16384 + 8]
GRAM_C = [32, 128]
GRAM_C_FWD = GRAM_C + [24]


def _gram_taps(dev, dtype, nl, tl, c, seed, b=2):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return gen, [torch.randn((b, tl, c), generator=gen, device=dev).to(dtype) for _ in range(nl)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", GRAM_C_FWD)
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


def _block_inputs(dev, dtype, rows, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = encoder.WIDTH
    rand = lambda *shape: torch.randn(shape, generator=gen, device=dev)  # noqa: E731
    return (rand(rows, c).to(dtype), (rand(3, c, c) * 0.05).to(dtype),
            rand(c) * 0.1, (rand(c, c) * 0.05).to(dtype), rand(c) * 0.1,
            rand(rows, c).to(dtype))


# Two clips of 1000 rows (2000: no multiple of the 128-row tile, a clip edge
# inside a tile) and three of 96; dilations from 1 to past the clip.
@pytest.mark.parametrize("clip,clips", [(1000, 2), (96, 3)])
@pytest.mark.parametrize("d", [1, 8, 64, 128, 512])
def test_tensor_core_encoder_block_kernels(dev, clip, clips, d):
    """The bf16 K7f / K7b on the tensor cores: K7f against its plain version
    and the tensor-core K1's output (the same code with the mask bytes
    compiled out: bit for bit); K7b, which recomputes the gate with K1's
    code, against its plain version fed bit 1 of the tensor-core K1's mask
    bytes, and bit for bit against the tensor-core K2 fed that gate and x > 0
    (the same product, then the same phase 2): its gate is K1's bit 1."""
    rows = clip * clips
    x, wd, bd, wr, br, g = _block_inputs(dev, torch.bfloat16, rows, d)
    out_k = encoder.block_fwd(x, wd, bd, wr, br, d, clip)
    out_k1, m_k1, _ = chain.layer_fwd(x, wd, bd, wr, br, d, clip)
    torch.cuda.synchronize()
    assert torch.equal(out_k, out_k1)
    assert _rel(out_k, encoder.block_fwd_plain(x, wd, bd, wr, br, d, clip)) <= TOL[x.dtype]

    dx_k = encoder.block_bwd(x, g, wd, bd, wr, d, clip)
    torch.cuda.synchronize()
    inrelu = (x > 0).to(torch.uint8)
    want = chain.layer_bwd_plain(g, None, m_k1, inrelu, wd, wr, d, clip)
    assert _rel(dx_k, want) <= TOL[x.dtype]
    assert torch.equal(dx_k, chain.layer_bwd(g, None, m_k1, inrelu, wd, wr, d, clip))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(16384, 1), (16384, 512), (40960, 4), (40960, 256)])
def test_windowed_encoder_block_kernels_match_plain(dev, dtype, rows, d):
    """K7f / K7b with the windows of the windowed K1/K2 test: the output is
    zero outside the window and equals the unwindowed output inside it; dx
    against the windowed plain version fed the same-code K1's gate; the full
    range is the unwindowed kernel bit for bit."""
    x, wd, bd, wr, br, g = _block_inputs(dev, dtype, rows, d)
    base = encoder.block_fwd(x, wd, bd, wr, br, d, rows)
    base_dx = encoder.block_bwd(x, g, wd, bd, wr, d, rows)
    _, m_k1, _ = chain.layer_fwd(x, wd, bd, wr, br, d, rows)
    inrelu = (x > 0).to(torch.uint8)
    for vw in [(4096 + 37, rows - 4096 - 61), (0, 1000), (rows - 200, rows), (300, 300),
               (-50, rows + 50), (777, 778)]:
        lo, hi = max(vw[0], 0), min(vw[1], rows)
        out_k = encoder.block_fwd(x, wd, bd, wr, br, d, rows, vw)
        dx_k = encoder.block_bwd(x, g, wd, bd, wr, d, rows, vw)
        torch.cuda.synchronize()
        assert _rel(out_k, encoder.block_fwd_plain(x, wd, bd, wr, br, d, rows, vw)) <= TOL[dtype]
        assert not out_k[:lo].any() and not out_k[hi:].any()
        assert torch.equal(out_k[lo:hi], base[lo:hi])
        want = chain.layer_bwd_plain(g, None, m_k1, inrelu, wd, wr, d, rows, vw)
        assert _rel(dx_k, want) <= TOL[dtype]
        if (lo, hi) == (0, rows):
            assert torch.equal(out_k, base) and torch.equal(dx_k, base_dx)


def test_encoder_block_kernels_choose_by_dtype_and_count(dev):
    """bfloat16 runs the tensor-core kernels, float32 the FMA kernels: in
    both K7f is K1's code of that dtype with the mask bytes compiled out (its
    output bit for bit); both count under K7f / K7b; float64 is refused."""
    for dtype in (torch.float32, torch.bfloat16):
        x, wd, bd, wr, br, g = _block_inputs(dev, dtype, 512, 3)
        _build.reset_launches()
        out = encoder.block_fwd(x, wd, bd, wr, br, 2, 256)
        dx = encoder.block_bwd(x, g, wd, bd, wr, 2, 256)
        counted = dict(_build.LAUNCHES)
        same_fwd = chain.layer_fwd(x, wd, bd, wr, br, 2, 256)[0]
        torch.cuda.synchronize()
        assert torch.equal(out, same_fwd) and dx.dtype == dtype
        assert counted["K7f"] == 1 and counted["K7b"] == 1
        with pytest.raises(TypeError):
            encoder.block_fwd(x.double(), wd, bd, wr, br, 2, 256)
        with pytest.raises(TypeError):
            encoder.block_bwd(x.double(), g.double(), wd, bd, wr, 2, 256)


def _k2_chain(layer, args, dils, clip, vw=None):
    """The single-layer K2 launches (``layer``) a group replaces."""
    dxn, dtaps, masks, inmask, wd, wr = args
    dx = dxn
    for j in range(len(dils) - 1, -1, -1):
        dx = layer(dx, dtaps[j], masks[j], masks[j - 1] if j else inmask, wd[j], wr[j], dils[j],
                   clip, vw)
    return dx


# Valid windows of three 256-row clips for the group (1, 2, 4, 8) at tile 128
# (bf16, tensor cores) or 32 (float32, FMA): edges inside tiles,
# inside the halos around the tile boundaries 64 and 128, clamped, and the
# full range.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("vw", [(37, 200), (60, 133), (-9, 300), (0, 256), (120, 137)])
def test_windowed_wavefront_group_kernel(dev, dtype, vw):
    """K2-wf with a valid window: against its windowed plain version, bit
    for bit against the windowed K2 launches it is built on (bf16: the
    tensor-core K2-wf against the tensor-core K2; float32: the FMA kernels),
    and with the full range bit for bit against no window."""
    clip, dils = 256, (1, 2, 4, 8)
    args = _wf_inputs(dev, dtype, dils, 3 * clip, missing=(2,), seed=7)
    group = chain.plan_bwd_groups(dils, clip, args[0].element_size())[0]
    assert group.tile == (128 if dtype == torch.bfloat16 else 32)
    _build.reset_launches()
    got = chain.group_bwd(*args, group, clip, vw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["K2wf"] == 1
    want = chain.group_bwd_plain(*args, dils, clip, group.tile, group.splits, vw)
    assert _rel(got, want) <= TOL[dtype]
    assert torch.equal(got, _k2_chain(chain.layer_bwd, args, dils, clip, vw))
    if max(vw[0], 0) == 0 and min(vw[1], clip) == clip:
        assert torch.equal(got, chain.group_bwd(*args, group, clip))


def test_new_tensor_core_kernels_spill_nothing(dev):
    """``tools/kernel_resources.py`` on csrc/trunk_mma.cu: K7f (the forward
    with kMasks false), K7b's phase 1 and the x-gated phase 2 are compiled,
    and no kernel of the file spills."""
    from audio_style_transfer_tpu_torch.tools import kernel_resources

    rows = kernel_resources.compile_resources(["trunk_mma.cu"])["trunk_mma.cu"]
    names = [r[0] for r in rows]
    for frag in ("trunk_fwd_mma_kernelILb0E", "trunk_fwd_mma_kernelILb1E",
                 "encoder_bwd_dy_mma_kernel", "trunk_bwd_dx_mma_kernelILb1E",
                 "trunk_bwd_dx_mma_kernelILb0E"):
        assert any(frag in name for name in names), (frag, names)
    for name, regs, st, ld, _ in rows:
        assert regs <= 255 and st == 0 and ld == 0, (name, regs, st, ld)


def test_tensor_core_wavefront_kernel_spills_nothing(dev):
    """``tools/kernel_resources.py`` on csrc/trunk_wf_mma.cu: the tensor-core
    K2-wf fits its 320 threads' registers (at most 204 each) and spills
    nothing."""
    from audio_style_transfer_tpu_torch.tools import kernel_resources

    rows = kernel_resources.compile_resources(["trunk_wf_mma.cu"])["trunk_wf_mma.cu"]
    assert [r[0] for r in rows if "trunk_bwd_wf_mma_kernel" in r[0]], rows
    for name, regs, st, ld, _ in rows:
        assert regs <= 204 and st == 0 and ld == 0, (name, regs, st, ld)


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
    against its plain version at the trunk tolerances, and bit for bit
    against the K2 launches ``layer_bwd`` makes (bf16: the tensor-core K2-wf
    against the tensor-core K2, same fragment code in the same order per
    row; float32: the FMA kernels)."""
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
    assert torch.equal(got, _k2_chain(chain.layer_bwd, args, dils, clip))


# The exact long-form runs' shapes: the scan's halo-extended window of 40960
# rows with its two edge windows and none, and the 15 s single window.
@pytest.mark.parametrize("rows,vw", [(40960, (4096, 40960)), (40960, (0, 14336)), (40960, None),
                                     (237568, None)])
def test_tensor_core_wavefront_group_at_the_exact_runs_shapes(dev, rows, vw):
    """bf16, one clip: the tensor-core K2-wf on the plan's group (1, 2, 4, 8)
    equals the tensor-core K2 launches bit for bit and its plain version at
    the tolerance."""
    dils = (1, 2, 4, 8)
    args = _wf_inputs(dev, torch.bfloat16, dils, rows, missing=(1,), seed=11)
    group = chain.plan_bwd_groups(dils, rows, 2)[0]
    assert group.tile == 128
    got = chain.group_bwd(*args, group, rows, vw)
    assert torch.equal(got, _k2_chain(chain.layer_bwd, args, dils, rows, vw))
    want = chain.group_bwd_plain(*args, dils, rows, group.tile, group.splits, vw)
    assert _rel(got, want) <= TOL[torch.bfloat16]


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


def test_tensor_core_wavefront_group_kernel_refuses_what_it_does_not_take(dev):
    clip = 240
    dils = (1, 2, 4, 8)
    args = _wf_inputs(dev, torch.bfloat16, dils, clip)
    # Not a whole number of 16-row fragments: the C entry point refuses it.
    bad = chain.BwdGroup(0, dils, 120, chain.wavefront_splits(dils, 120, None))
    with pytest.raises(RuntimeError, match="ast_trunk_bwd_group_mma"):
        chain.group_bwd(*args, bad, clip)
    # The first step's phase 2 needs 11 fragments, one a warp of 10.
    wide = (8, 9, 1)
    args3 = _wf_inputs(dev, torch.bfloat16, wide, 256)
    group = chain.BwdGroup(0, wide, 128, chain.wavefront_splits(wide, 128, None))
    with pytest.raises(RuntimeError, match="ast_trunk_bwd_group_mma"):
        chain.group_bwd(*args3, group, 256)
    # Four weights and two buffers of 128 + 96 + 16 rows: past a block's shared memory.
    big = (16, 32)
    args2 = _wf_inputs(dev, torch.bfloat16, big, 256)
    group = chain.BwdGroup(0, big, 128, chain.wavefront_splits(big, 128, None))
    with pytest.raises(ValueError, match="shared memory"):
        chain.group_bwd(*args2, group, 256)
    # A tile that does not divide the clip.
    with pytest.raises(ValueError, match="multiple of the tile"):
        chain.group_bwd(*args, chain.plan_bwd_groups(dils, 256, 2)[0], clip)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_trunk_backward_with_the_wavefront_switch_on_card(dev, dtype, monkeypatch):
    """dils (1, 2, 4, 8, 64): with the switch on the backward is one K2-wf
    launch and one K2 launch, and equals the five K2 launches bit for bit,
    in both types with the kernels ``layer_bwd`` / ``group_bwd`` choose."""
    rng = np.random.RandomState(5)
    c, dils, emit = chain.WIDTH, (1, 2, 4, 8, 64), (1, 3, 4)
    arrs = [rng.randn(2, 256, c), rng.randn(5, 3, c, c) * 0.05, rng.randn(5, c) * 0.1,
            rng.randn(5, c, c) * 0.05, rng.randn(5, c) * 0.1]
    cts = [torch.tensor(rng.randn(2, 256, c), dtype=torch.float32, device=dev).to(dtype)
           for _ in emit]
    grads = {}
    for on in (False, True):
        monkeypatch.setattr(chain, "_BWD_WAVEFRONT", on)
        ts = [torch.tensor(a, dtype=torch.float32, device=dev).to(dtype) for a in arrs]
        ts[0].requires_grad_(True)
        _build.reset_launches()
        taps = chain.fused_trunk(*ts, dils, emit)
        (grads[on],) = torch.autograd.grad(taps, ts[0], cts)
        torch.cuda.synchronize()
        want = {"K1": 5, "K2": 1, "K2wf": 1} if on else {"K1": 5, "K2": 5, "K2wf": 0}
        assert {k: _build.LAUNCHES[k] for k in want} == want
    assert torch.equal(grads[True], grads[False])


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


# Generation (generate/fastgen.py): the decoder step captured into a CUDA
# graph and replayed per sample. Full width (512, skip 256) with one stage of
# dilations (1..512, 10 layers) so that the CPU plain loops stay short.
GEN_CFG = dict(num_layers=10)
# Logits: f32 and bf16 weights 1e-4 * max + 1e-5 (f32 sums in other orders).
# int8 1e-2 * max + 1e-4: int8 rounds each product's input x to bf16, and a
# rounding that flips on an upstream ulp moves x by 2^-8 of itself and later
# inputs across other rounding boundaries; at this geometry two f32 sum
# orders on the CPU alone put the int8 logits 3.5e-3 * max apart
# (tools/probe_int8_order.py), the f32 ones 5.7e-7 * max.
GEN_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (1e-4, 1e-5), "int8": (1e-2, 1e-4)}


def _gen_setup(dev, fmt="float32", batch=2, frames=2, seed=0):
    from audio_style_transfer_tpu_torch.generate import fastgen
    from audio_style_transfer_tpu_torch.models.wavenet_ae import WaveNetAEConfig, init_params

    cfg = WaveNetAEConfig(**GEN_CFG)
    params = init_params(seed, cfg)
    if fmt == "bfloat16":
        params = {k: {m: v.to(torch.bfloat16) for m, v in e.items()} for k, e in params.items()}
    elif fmt == "int8":
        params = fastgen.quantize_params_int8(params)
    gen = np.random.RandomState(seed)
    xq = np.floor(gen.uniform(-128, 128, (batch, frames * cfg.ae_hop_length))).astype(np.float32)
    enc = (gen.randn(batch, frames, cfg.ae_bottleneck_width) * 0.5).astype(np.float32)
    on_card = {k: {m: v.to(dev) for m, v in e.items()} for k, e in params.items()}
    return fastgen, cfg, params, on_card, xq, enc


def _within(got, ref, fmt):
    rel, abs_ = GEN_TOL[fmt]
    return float((got.cpu() - ref.cpu()).abs().max()) <= rel * float(ref.abs().max()) + abs_


def test_graphed_step_equals_the_eager_step_bit_for_bit(dev):
    fastgen, cfg, _, p, xq, enc = _gen_setup(dev)
    graphed = fastgen.incremental_logits(p, xq[:, :200], enc[:, :1], cfg)
    eager = fastgen.incremental_logits(p, xq[:, :200], enc[:, :1], cfg, eager=True)
    torch.cuda.synchronize()
    assert torch.equal(graphed, eager)
    audio = [fastgen.sample_loop(p, enc[:, :1], torch.Generator(device=dev).manual_seed(5), cfg,
                                 eager=eager) for eager in (False, True)]
    assert torch.equal(audio[0], audio[1])


def test_graphed_incremental_logits_match_decode_logits(dev):
    from audio_style_transfer_tpu_torch.models.wavenet_ae import decode_logits

    fastgen, cfg, _, p, xq, enc = _gen_setup(dev)
    got = fastgen.incremental_logits(p, xq, enc, cfg)
    ref = decode_logits(p, torch.tensor(xq, device=dev), torch.tensor(enc, device=dev), cfg)
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and _within(got, ref, "float32")


@pytest.mark.parametrize("fmt", ["float32", "bfloat16", "int8"])
def test_graphed_formats_match_their_cpu_plain_loops(dev, fmt):
    fastgen, cfg, cpu, p, xq, enc = _gen_setup(dev, fmt)
    got = fastgen.incremental_logits(p, xq, enc, cfg)
    ref = fastgen.incremental_logits(cpu, xq, enc, cfg)
    torch.cuda.synchronize()
    assert _within(got, ref, fmt)


def test_a_cuda_tensor_reaches_the_eager_loop_only_when_asked(dev, monkeypatch):
    """Graphed, the step function runs twice (the warm-up and the capture)
    however many samples; eager, once per sample."""
    fastgen, cfg, _, p, xq, enc = _gen_setup(dev, frames=1)
    calls = []
    step = fastgen._decoder_step
    monkeypatch.setattr(fastgen, "_decoder_step", lambda *a: calls.append(1) or step(*a))
    fastgen.synthesize(enc, params=p, cfg=cfg)
    assert len(calls) == 2
    calls.clear()
    fastgen.sample_loop(p, enc, torch.Generator(device=dev), cfg, eager=True)
    assert len(calls) == cfg.ae_hop_length


def test_int8_weights_stay_int8_on_the_device(dev):
    fastgen, cfg, _, p, _, _ = _gen_setup(dev, "int8")
    w = fastgen._DecoderWeights(p, cfg)
    for lin in (*w.dil, *w.res_skip, w.skip_start, w.out1, w.logits):
        assert lin.w.dtype == torch.int8 and lin.w.device.type == "cuda"
        assert lin.scale.dtype == torch.float32
    bf = fastgen._DecoderWeights(_gen_setup(dev, "bfloat16")[3], cfg)
    assert all(lin.w.dtype == torch.bfloat16 for lin in (*bf.dil, *bf.res_skip))


# --- training (train/trainer.py): the step on the card --------------------

# ae_width 128 (the trunk kernels' width), a narrow decoder.
TRAIN_CFG = dict(num_layers=4, num_stages=2, width=64, skip_width=32, ae_num_layers=6,
                 ae_num_stages=3, ae_hop_length=64, ae_bottleneck_width=8)


def _rel_l2(a, b):
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def test_one_train_step_on_card_matches_cpu(dev):
    """float32: K1/K2 and cuBLAS on the card against the plain versions on
    the CPU from the same weights and batch. Loss rel 1e-5; each gradient
    rel L2 5e-3 (relu gates near zero flip). Adam's first step is
    lr * g / (|g| + eps): a weight moves by about lr whatever its gradient's
    size, so the updated weights may differ by more than 1e-6 only where a
    gradient near zero differs in sign or size: on at most 1e-3 of them, as
    chip_smoke.py holds the full-width step."""
    from audio_style_transfer_tpu_torch.models.wavenet_ae import WaveNetAEConfig
    from audio_style_transfer_tpu_torch.train import TrainConfig, Trainer
    from audio_style_transfer_tpu_torch.train.trainer import _leaves

    wav = np.random.RandomState(0).uniform(-0.8, 0.8, (2, 1024)).astype(np.float32)
    out = {}
    for where in ("cpu", dev):
        tr = Trainer(TrainConfig(save_every_steps=0), WaveNetAEConfig(**TRAIN_CFG), device=where)
        st, loss = tr.step(tr.init_state(), wav)
        out[str(where)] = (float(loss), [p.grad for p in _leaves(st["params"])],
                           [p.detach() for p in _leaves(st["params"])])
    (lc, gc, pc), (lg, gg, pg) = out["cpu"], out[str(dev)]
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for a, b in zip(gg, gc):
        if float(b.norm()) == 0:
            assert float(a.abs().max()) == 0
        else:
            assert _rel_l2(a, b) <= 5e-3
    moved = sum(int(((a.cpu() - b).abs() > 1e-6).sum()) for a, b in zip(pg, pc))
    total = sum(b.numel() for b in pc)
    print(f"{moved} of {total} updated weights differ by more than 1e-6")
    assert moved <= 1e-3 * total


# --- the decoder block's fused epilogues (ops/decoder.py) ---------------------

# (B, T, frames a clip): the training step's rows; a ragged one (3 clips, 3
# frames each). Width 512 (y is [B, T, 1024]), skip 256.
DECODER_SHAPES = [(32, 6144, 12), (3, 1536, 3)]
# dc and the biases' sums: the same rounded dz (or gradients) summed in float32
# in another order, as max|d| over the largest entry.
DECODER_SUM_TOL = 1e-4


def _decoder_inputs(dev, dtype, b, t, frames, m=512, skip=256):
    gen = torch.Generator(device=dev).manual_seed(b + t)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    return dict(y=rand(b, t, 2 * m, scale=2.0), c=rand(b, frames, 2 * m),
                b_dil=rand(2 * m, scale=0.3), b_cond=rand(2 * m, scale=0.3),
                dgated=rand(b, t, m), l=rand(b, t, m), s=rand(b, t, skip), r=rand(b, t, m),
                k=rand(b, t, skip), b_res=rand(m, scale=0.3), b_skip=rand(skip, scale=0.3))


@pytest.mark.parametrize("shape", DECODER_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decoder_kernels_match_plain(dev, dtype, shape):
    """Each of the four kernels against its plain version on the same card:
    the gate and residual forwards bit for bit (they round where eager
    PyTorch rounds, with its sigmoid and tanh); the gate backward's dz, whose
    only difference is the kernel's fused multiply-add in 1 - tanh^2 (one
    rounding where the plain version's two ops round twice): bf16 element by
    element within one bf16 step of the plain version's, float32 within TOL
    of its largest entry (near |tanh| = 1 the product's rounding is most of
    1 - tanh^2); dc and the four bias gradients within DECODER_SUM_TOL. One
    launch each."""
    from audio_style_transfer_tpu_torch.ops import decoder

    x = _decoder_inputs(dev, dtype, *shape)
    gate = (x["y"], x["c"], x["b_dil"], x["b_cond"])
    res = (x["l"], x["s"], x["r"], x["k"], x["b_res"], x["b_skip"])
    _build.reset_launches()
    gated = decoder.gate_fwd(*gate)
    dz, dc = decoder.gate_bwd(*gate, x["dgated"])
    lo, so = decoder.residual_fwd(*res)
    db_res, db_skip = decoder.residual_bwd(x["l"], x["s"])
    torch.cuda.synchronize()
    assert {k: _build.LAUNCHES[k] for k in ("gate_fwd", "gate_bwd", "residual_fwd",
                                            "residual_bwd")} == dict.fromkeys(
        ("gate_fwd", "gate_bwd", "residual_fwd", "residual_bwd"), 1)
    assert torch.equal(gated, decoder.gate_fwd_plain(*gate))
    lp, sp = decoder.residual_fwd_plain(*res)
    assert torch.equal(lo, lp) and torch.equal(so, sp)
    dz_p, dc_p = decoder.gate_bwd_plain(*gate, x["dgated"])
    print(f"{dtype} {shape}: dz differs on {float((dz != dz_p).float().mean()):.2e} of "
          f"elements, max|d| over max {_rel(dz, dz_p):.2e}")
    assert dz.dtype == dtype and _rel(dz, dz_p) <= TOL[dtype]
    if dtype == torch.bfloat16:  # one bf16 step is at most 2^-7 of the value
        assert not bool(((dz.float() - dz_p.float()).abs() > 2.0 ** -7 * dz_p.float().abs()).any())
    assert dc.dtype == torch.float32 and _rel(dc, dc_p) <= DECODER_SUM_TOL
    assert _rel(dc.sum((0, 1)), dc_p.sum((0, 1))) <= DECODER_SUM_TOL
    for got, want in zip((db_res, db_skip), decoder.residual_bwd_plain(x["l"], x["s"])):
        assert got.dtype == torch.float32 and _rel(got, want) <= DECODER_SUM_TOL
    # dc is the kernel's own dz summed over each frame's rows, and no others.
    b, t, frames = shape
    dz_sum = dz.float().reshape(b, frames, t // frames, -1).sum(2)
    assert _rel(dc, dz_sum) <= DECODER_SUM_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decoder_fused_train_loss_matches_the_plain_blocks(dev, dtype, monkeypatch):
    """One ``train_loss`` backward with remat at the full geometry (30 blocks
    of 512, 2 x 6144), biases drawn nonzero: the fused blocks against the
    plain blocks on the card (``_decoder_block`` swapped for the plain one),
    within the tolerances of test_one_train_step_on_card_matches_cpu (loss rel
    1e-5, each gradient rel L2 5e-3). The fused step launches the gate
    forward 60 times (forward and remat re-forward), the residual forward 30
    (the re-forward stops at the last tensor the backward keeps, the gated
    input of the res and skip products) and each backward 30 times; the
    plain one none of them."""
    from audio_style_transfer_tpu_torch.models import wavenet_ae
    from audio_style_transfer_tpu_torch.train.trainer import train_loss

    cfg = wavenet_ae.WaveNetAEConfig(compute_dtype=dtype, remat=True)
    params = wavenet_ae.init_params(0, cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(9)
    for e in params.values():
        e["b"].uniform_(-0.1, 0.1, generator=gen)
    wav = torch.tensor(np.random.RandomState(0).uniform(-0.8, 0.8, (2, 6144)),
                       dtype=torch.float32, device=dev)
    leaves = [v.requires_grad_(True) for e in params.values() for v in e.values()]
    out = {}
    for route in ("fused", "plain"):
        if route == "plain":
            monkeypatch.setattr(wavenet_ae, "_decoder_block", wavenet_ae._plain_decoder_block)
        _build.reset_launches()
        loss = train_loss(params, wav, cfg)
        # The last block's res conv reaches no loss: no gradient on either route.
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        torch.cuda.synchronize()
        out[route] = (float(loss.detach()), grads, {k: _build.LAUNCHES[k] for k in (
            "gate_fwd", "gate_bwd", "residual_fwd", "residual_bwd")})
    (lf, gf, nf), (lp, gp, np_) = out["fused"], out["plain"]
    assert nf == {"gate_fwd": 60, "gate_bwd": 30, "residual_fwd": 30, "residual_bwd": 30}
    assert not any(np_.values())
    assert abs(lf - lp) <= 1e-5 * abs(lp)
    worst = 0.0
    # The same leaves get no gradient (res_30's) on both routes: no product
    # backward runs for them.
    assert [g is None for g in gf] == [g is None for g in gp]
    for a, b in zip(gf, gp):
        if b is None:
            continue
        if float(b.norm()) == 0:
            assert float(a.abs().max()) == 0
        else:
            worst = max(worst, _rel_l2(a, b))
    print(f"{dtype}: loss {lf} / {lp}; worst gradient rel L2 {worst:.2e}")
    assert worst <= 5e-3


def test_decoder_kernels_refuse_what_they_do_not_take(dev):
    """Each wrapper raises on a non-contiguous operand, a T that is no
    multiple of the frame count, a CPU / CUDA mix, a dtype other than float32
    and bfloat16, and a width that is no multiple of 8."""
    from audio_style_transfer_tpu_torch.ops import decoder

    x = _decoder_inputs(dev, torch.bfloat16, 2, 1024, 2)
    y, c, bd, bc, dg = x["y"], x["c"], x["b_dil"], x["b_cond"], x["dgated"]
    l, s, r, k, br, bs = x["l"], x["s"], x["r"], x["k"], x["b_res"], x["b_skip"]
    strided = lambda a: a.transpose(0, 1).contiguous().transpose(0, 1)  # noqa: E731
    cut = lambda a, n: a[..., :n].contiguous()  # noqa: E731
    ragged = lambda a: a[:, :1001].contiguous()  # noqa: E731
    cases = [
        ("contiguous", decoder.gate_fwd, (strided(y), c, bd, bc)),
        ("frame count", decoder.gate_fwd, (ragged(y), c, bd, bc)),
        ("one device", decoder.gate_fwd, (y, c.cpu(), bd, bc)),
        ("float32 or bfloat16", decoder.gate_fwd,
         (y.double(), c.double(), bd.double(), bc.double())),
        ("multiple of 8", decoder.gate_fwd, (cut(y, 1000), cut(c, 1000), bd[:1000], bc[:1000])),
        ("contiguous", decoder.gate_bwd, (y, c, bd, bc, strided(dg))),
        ("frame count", decoder.gate_bwd, (ragged(y), c, bd, bc, ragged(dg))),
        ("one device", decoder.gate_bwd, (y, c, bd, bc, dg.cpu())),
        ("contiguous", decoder.residual_fwd, (l, s, strided(r), k, br, bs)),
        ("one B and T", decoder.residual_fwd, (l, s, r, ragged(k), br, bs)),
        ("one device", decoder.residual_fwd, (l, s.cpu(), r, k, br, bs)),
        ("bfloat16", decoder.residual_fwd, (l, s, r.float(), k, br, bs)),
        ("multiples of 8", decoder.residual_fwd, (cut(l, 500), s, cut(r, 500), k, br[:500], bs)),
        ("contiguous", decoder.residual_bwd, (strided(l), s)),
        ("one B and T", decoder.residual_bwd, (l, ragged(s))),
        ("one device", decoder.residual_bwd, (l, s.cpu())),
        ("multiples of 8", decoder.residual_bwd, (cut(l, 500), s)),
    ]
    _build.reset_launches()
    for match, fn, args in cases:
        with pytest.raises((ValueError, TypeError), match=match):
            fn(*args)
    assert not any(_build.LAUNCHES.values())


def test_world_one_nccl_trainer_equals_mesh_none(dev):
    """Trainer(mesh=make_mesh(1)) over NCCL at world size 1: two steps equal
    mesh=None's bit for bit (one rank's all-reduce and the division by 1 are
    exact), with K1 and K2 launched once a layer a step either way; NCCL's
    gather of host rows (``optimize_batch(mesh=)``'s) returns them."""
    import torch.distributed as dist

    from audio_style_transfer_tpu_torch.models.wavenet_ae import WaveNetAEConfig
    from audio_style_transfer_tpu_torch.parallel import make_mesh
    from audio_style_transfer_tpu_torch.parallel.mesh import gather_rows
    from audio_style_transfer_tpu_torch.train import TrainConfig, Trainer
    from audio_style_transfer_tpu_torch.train.trainer import _leaves

    wavs = np.random.RandomState(1).uniform(-0.8, 0.8, (2, 2, 1024)).astype(np.float32)
    mesh = make_mesh(1)
    try:
        assert dist.get_backend() == "nccl"
        out = []
        for m in (None, mesh):
            tr = Trainer(TrainConfig(save_every_steps=0), WaveNetAEConfig(**TRAIN_CFG), mesh=m,
                         device=dev)
            st = tr.init_state()
            _build.reset_launches()
            losses = [tr.step(st, w)[1] for w in wavs]
            assert _build.LAUNCHES["K1"] == _build.LAUNCHES["K2"] == 2 * TRAIN_CFG["ae_num_layers"]
            out.append((torch.stack(losses), _leaves(st["params"]) + _leaves(st["ema"])))
        rows = np.arange(6, dtype=np.float32).reshape(3, 2)
        np.testing.assert_array_equal(gather_rows(mesh, rows), rows)
    finally:
        dist.destroy_process_group()
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_world_one_nccl_sharded_loss_equals_mesh_none(dev):
    """The time-sharded exact loss (``halo.make_sharded_loss_fn``) over
    ``make_mesh(1)`` (NCCL, world size 1: zero halos, the windowed K1/K2 with
    (radius, chunk + radius), one rank's all-reduces) against the one-window
    loss of ``mesh=None`` on the same 8192-sample clip, float32, the 30-layer
    encoder at full width, stack 0, gamma 1e-3: the same rows through the
    same kernels, the grams summed over other tiles, so loss rtol 1e-4 and
    gradient max|d| within 1e-4 of its largest entry. One evaluation launches
    K1 30, K2 30, K5 1, K6 1."""
    import torch.distributed as dist

    from audio_style_transfer_tpu_torch.models.wavenet_ae import WaveNetAEConfig, init_params
    from audio_style_transfer_tpu_torch.parallel import halo, make_mesh
    from audio_style_transfer_tpu_torch.transfer.losses import LossSpec

    cfg, t = WaveNetAEConfig(), 8192
    spec = LossSpec(cont_lyr_ids=(29,), style_layer_ids=tuple(range(10)), gamma=1e-3)
    params = {k: {m: v.to(dev) for m, v in e.items()} for k, e in init_params(0, cfg).items()}
    rng = np.random.RandomState(3)
    x = torch.tensor(rng.uniform(-100, 100, (1, t)), dtype=torch.float32, device=dev)
    target = torch.tensor(rng.uniform(-100, 100, (1, t)), dtype=torch.float32, device=dev)
    with torch.no_grad():
        phi_c, phi_s = halo._single_window_exact_embeds_fn(cfg, spec)(params, target)
    out = []
    mesh = make_mesh(1, axis_name="time")
    try:
        assert dist.get_backend() == "nccl"
        for loss_fn in (halo._single_window_exact_loss_fn(cfg, spec, t),
                        halo.make_sharded_loss_fn(cfg, spec, mesh, "time")):
            xv = x.clone().requires_grad_(True)
            _build.reset_launches()
            loss = loss_fn(params, xv, phi_c, phi_s)
            (g,) = torch.autograd.grad(loss, xv)
            torch.cuda.synchronize()
            out.append((float(loss.detach()), g, dict(_build.LAUNCHES)))
    finally:
        dist.destroy_process_group()
    (l0, g0, n0), (l1, g1, n1) = out
    assert abs(l1 - l0) <= 1e-4 * abs(l0)
    assert _rel(g1, g0) <= 1e-4
    assert n0 == n1 and (n1["K1"], n1["K2"], n1["K5"], n1["K6"]) == (30, 30, 1, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_trunk_weight_gradients_through_k1_k2_match_plain_autograd(dev, dtype):
    """TrunkFunction (K1 forward, K2 for dx, the weight gradients by
    recompute) against autograd through ``reference_trunk`` alone, at 30
    layers on 2 clips of 6144 rows; taps 9 and 29 carry cotangents. The
    weight gradients come from the same recompute: equal. dx: float32 within
    rel L2 5e-3 (relu gates near zero flip; PRs 1-3 saw 1.1e-3). bfloat16:
    both are held to the float32 autograd on the same bf16 values; K2's dx
    (masks from K1, float32 gate pre-activations) may be no further from it
    than twice the plain bf16 autograd's (bf16 roundings of y at other
    points) plus 1e-3."""
    gen = torch.Generator(device=dev).manual_seed(3)
    c = chain.WIDTH
    dils = tuple(2 ** (j % 10) for j in range(30))
    x = (torch.randn((2, 6144, c), generator=gen, device=dev) * 0.5).to(dtype)
    ws = [(torch.randn((30, 3, c, c), generator=gen, device=dev) * 0.05).to(dtype),
          (torch.randn((30, c), generator=gen, device=dev) * 0.05).to(dtype),
          (torch.randn((30, c, c), generator=gen, device=dev) * 0.05).to(dtype),
          (torch.randn((30, c), generator=gen, device=dev) * 0.05).to(dtype)]
    cot = [torch.randn((2, 6144, c), generator=gen, device=dev).to(dtype) for _ in range(2)]
    grads = {}
    runs = (("kernels", chain.fused_trunk, dtype), ("plain", chain.reference_trunk, dtype),
            ("f32", chain.reference_trunk, torch.float32))
    for name, fn, dt in runs:
        xi = x.to(dt).requires_grad_(True)
        wi = [w.to(dt).requires_grad_(True) for w in ws]
        torch.cuda.reset_peak_memory_stats(dev)
        taps = fn(xi, *wi, dils, (9, 29))
        grads[name] = torch.autograd.grad(taps, [xi, *wi], [g.to(dt) for g in cot])
        torch.cuda.synchronize()
        print(f"{name} {dt}: peak {torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB")
    for a, b in zip(grads["kernels"][1:], grads["plain"][1:]):
        assert torch.equal(a, b)
    if dtype == torch.float32:
        assert _rel_l2(grads["kernels"][0], grads["plain"][0]) <= 5e-3
    else:
        ek = _rel_l2(grads["kernels"][0], grads["f32"][0])
        ep = _rel_l2(grads["plain"][0], grads["f32"][0])
        print(f"bf16 dx against the f32 autograd: kernels {ek:.3e}, plain {ep:.3e}")
        assert ek <= 2 * ep + 1e-3


def _bf16_order(a):
    """bfloat16 values as integers in their order: adjacent values differ by 1."""
    bits = a.contiguous().view(torch.int16).int()
    mag = bits & 0x7FFF
    return torch.where(bits < 0, -mag, mag)


def _rounded_once(got, exact, scale, k: int):
    """Against ``exact`` (float64) rounded once to bfloat16: (the share of
    elements whose bits differ, the number of those more than one bfloat16
    step away and also further from ``exact`` than float32 sums of k terms
    can be: k 2^-24 times ``scale``, the sum of the terms' magnitudes; within
    that bound a value that nearly cancels has no defined rounding)."""
    steps = (_bf16_order(got) - _bf16_order(exact.to(torch.bfloat16))).abs()
    far = (steps > 1) & ((got.double() - exact).abs() > k * 2.0 ** -24 * scale)
    return float((steps != 0).float().mean()), int(far.sum())


def _one_rounding_share(k: int) -> float:
    """Share of elements allowed to differ from the float64 result rounded
    once, for products that sum k terms in float32: the float32 sum carries
    a relative error of order sqrt(k) 2^-24 (a random walk of roundings),
    so an exact value that close to a bfloat16 rounding boundary (spacing
    2^-8) may round the other way: a share of order sqrt(k) 2^-16; allowed
    8 times that. Rounding each tap's product apart differs on 0.32-0.45
    (measured, NVIDIA H100 80GB HBM3)."""
    return k ** 0.5 * 2.0 ** -13


def test_bf16_conv_is_one_tensor_core_product_rounded_once(dev):
    """ops.conv.conv1d on bfloat16 CUDA tensors (the taps merged into one
    bf16 product, float32 sums) against the float64 conv of the same values
    rounded once to bfloat16: the output, dx and dw equal it bit for bit on
    all but ``_one_rounding_share`` of the elements and within one bfloat16
    step on those; the bias is then one bf16 add. A conv that rounds each
    tap's product and sums them in bf16 is planted and fails. The global
    reduced-precision flag is left as it was, on or off."""
    from audio_style_transfer_tpu_torch.ops import conv

    bf16 = torch.bfloat16
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    gen = torch.Generator(device=dev).manual_seed(4)
    rows = 2 * 2048
    try:
        for setting, (f, d, cin, cout) in zip(
                (True, False, True), ((3, 4, 512, 1024), (1, 1, 512, 256), (3, 512, 128, 128))):
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = setting
            x = torch.randn((2, 2048, cin), generator=gen, device=dev).to(bf16)
            w = (torch.randn((f, cin, cout), generator=gen, device=dev) * cin ** -0.5).to(bf16)
            b = (torch.randn((cout,), generator=gen, device=dev) * 0.1).to(bf16)
            xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
            got = conv.conv1d(xr, wr, None, dilation=d, causal=True)
            g = torch.randn(got.shape, generator=gen, device=dev).to(bf16)
            dx, dw = torch.autograd.grad(got, [xr, wr], g)
            assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction == setting
            assert got.dtype == dx.dtype == dw.dtype == bf16
            assert torch.equal(conv.conv1d(x, w, b, dilation=d, causal=True), got.detach() + b)
            exact, scale = [], []
            for a, v in ((x, w), (x.abs(), w.abs())):  # the conv, the terms' magnitudes
                xf, wf = a.double().requires_grad_(True), v.double().requires_grad_(True)
                y = sum(xk @ wf[k] for k, xk in enumerate(conv._shifted(xf, f, d, True)))
                dxf, dwf = torch.autograd.grad(y, [xf, wf],
                                               g.double() if v is w else g.double().abs())
                (exact if v is w else scale).append([y.detach(), dxf, dwf])
            for i, (name, a, k) in enumerate((("y", got, f * cin), ("dx", dx, f * cout),
                                              ("dw", dw, rows))):
                share, far = _rounded_once(a.detach(), exact[0][i], scale[0][i], k)
                print(f"F={f} Cin={cin} Cout={cout} {name}: {share:.2e} differ (allowed "
                      f"{_one_rounding_share(k):.1e}), {far} beyond one step")
                assert share <= _one_rounding_share(k) and far == 0, name
            if f > 1:
                planted = None
                for k, xk in enumerate(conv._shifted(x, f, d, True)):
                    term = xk @ w[k]
                    planted = term if planted is None else planted + term
                share, _ = _rounded_once(planted, exact[0][0], scale[0][0], f * cin)
                print(f"F={f}: per-tap rounding differs on {share:.2e}")
                assert share > _one_rounding_share(f * cin)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag


# The baseline spectral AE and the spectrogram / CQT chain on the card: cuDNN
# convs and torch.fft / torch.matmul (no hand-written kernel), float32 with
# TF32 off, held to the same functions on the CPU.
BASELINE_SHALLOW = dict(
    num_latent=8, pitch_embedding_dim=8, n_fft=64,
    encoder_spec=(((5, 5), (2, 2), 16), ((4, 4), (2, 2), 16), ((4, 4), (2, 2), 32)),
    decoder_spec=(((4, 4), (2, 2), 32), ((4, 4), (2, 2), 16), ((5, 5), (2, 2), 16)))


def test_baseline_convs_turn_tf32_off_and_restore_it(dev):
    from audio_style_transfer_tpu_torch.models import baseline_ae

    cudnn = torch.backends.cudnn
    before = cudnn.allow_tf32
    try:
        cudnn.allow_tf32 = True
        with baseline_ae.f32_convs():
            assert cudnn.allow_tf32 is False
        assert cudnn.allow_tf32 is True
    finally:
        cudnn.allow_tf32 = before


def test_baseline_step_on_the_card_matches_the_cpu(dev):
    """One Adam step at the shallow geometry, TF32 on outside the model (the
    model turns it off): the loss to 1e-5, every gradient to 1e-4 of its
    largest entry (float32 sums of cuDNN's order) except the biases before a
    training-mode BN, whose gradients are rounding noise (zero in exact
    arithmetic); the updated BN statistics to 1e-5."""
    from audio_style_transfer_tpu_torch.models import baseline_ae as tb

    hp = tb.BaselineHParams(**BASELINE_SHALLOW)
    rng = np.random.RandomState(0)
    spec = torch.tensor(rng.rand(2, 32, 16, 1).astype(np.float32))
    pitch = torch.tensor([60, 64])
    out = {}
    torch.backends.cudnn.allow_tf32 = True
    try:
        for where in ("cpu", dev):
            model = tb.BaselineAE(hp, seed=1).to(where)
            opt = tb.make_optimizer(model)
            loss = tb.train_step(model, opt, spec.to(where), pitch.to(where))
            out[str(where)] = (float(loss), {n: p.grad.cpu() for n, p in model.named_parameters()},
                               {n: b.cpu() for n, b in model.named_buffers()})
    finally:
        torch.backends.cudnn.allow_tf32 = False
    (lc, gc, bc), (lg, gg, bg) = out["cpu"], out[str(dev)]
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for n in gc:
        if n.endswith(".b") and not n.startswith("mag_out"):
            continue
        assert _rel(gg[n], gc[n]) <= 1e-4, n
    for n in bc:
        assert _rel(bg[n], bc[n]) <= 1e-5, n


def test_spectrogram_chain_on_the_card_matches_the_cpu(dev):
    """Batched specgram features (per-clip maxima), istft's overlap-add
    (equal bits on two runs: F.fold sums without atomics) and 5 Griffin-Lim
    iterations from one phase, card against CPU."""
    from audio_style_transfer_tpu_torch.signal import specgram as sg
    from audio_style_transfer_tpu_torch.signal.stft import centered_stft, istft

    rng = np.random.RandomState(1)
    x = torch.tensor((rng.randn(3, 16000) * [[1e-3], [0.5], [0.05]]).astype(np.float32))
    want = sg.specgram(x, n_fft=1024, hop_length=256, mag_only=True)
    got = sg.specgram(x.to(dev), n_fft=1024, hop_length=256, mag_only=True)
    assert float((got.cpu() - want).abs().max()) <= 1e-4
    spec = centered_stft(x.to(dev), 1024, 256)
    a, b = istft(spec, 1024, 256), istft(spec, 1024, 256)
    assert torch.equal(a, b)
    assert _rel(a.cpu(), istft(spec.cpu(), 1024, 256)) <= 1e-5
    mag = spec[1].abs()
    phase = torch.rand(mag.shape, generator=torch.Generator().manual_seed(0)) * np.pi
    gl = sg.griffin_lim(mag, phase.to(dev), 1024, 256, 5)
    assert _rel(gl.cpu(), sg.griffin_lim(mag.cpu(), phase, 1024, 256, 5)) <= 1e-4


def test_cqt_on_the_card_matches_the_cpu(dev):
    from audio_style_transfer_tpu_torch.signal.cqt import cqt

    x = torch.tensor(np.random.RandomState(2).randn(2, 32000).astype(np.float32))
    got, want = cqt(x.to(dev)).cpu(), cqt(x)
    assert got.shape == want.shape == (2, 240, 126)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5


def test_scipy_parity_at_width_128_on_the_card(dev):
    """transfer/scipy_parity.py's run_parity at full width (30 layers of 128,
    stack 0) on a T=4096 clip, one seed, maxiter 100 (the module's default:
    the rule compares converged losses; cut at 30 iterations both legs stop
    mid-descent at the cap): the record passes main()'s rule, and the run
    launched K1, K2, K5 and K6 and nothing else."""
    import json

    from audio_style_transfer_tpu_torch.transfer import scipy_parity

    _build.reset_launches()
    (record,) = scipy_parity.run_parity(t=4096, maxiter=100, seeds=1, device=str(dev))
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    assert scipy_parity.passes(record), json.dumps(record)
    assert all(launches[k] > 0 for k in ("K1", "K2", "K5", "K6")), launches
    assert all(launches[k] == 0 for k in ("K2wf", "K7f", "K7b")), launches
