"""ops/decoder.py on the CPU: the plain versions of the decoder block's fused
epilogues, with their hand-written backward formulas (dz, the hop-frame sum
into dc, both bias gradients from dc, the residual's column sums), against
autograd of the block's original eager expression, and the fused block
(``_fused_decoder_block``, the route of CUDA tensors) against the plain one.
The kernels themselves are held to these plain versions on the card
(tests/test_torch_cuda.py)."""

import dataclasses

import pytest
import torch

from audio_style_transfer_tpu_torch.models import wavenet_ae
from audio_style_transfer_tpu_torch.ops import decoder
from audio_style_transfer_tpu_torch.ops.conv import condition

# (B, T, frames, m): three frames of four rows; a ragged one (five frames of
# three rows, m not a multiple of 8: the plain versions take any width).
SHAPES = [(2, 12, 3, 8), (3, 15, 5, 4)]
# Autograd against the hand-written formulas: the same operations, summed in
# other orders.
GRAD_TOL = {torch.float64: 1e-12, torch.float32: 2e-6}


def _gate_inputs(shape, dtype, seed=0):
    b, t, f, m = shape
    g = torch.Generator().manual_seed(seed)
    rand = lambda *s: torch.randn(s, generator=g, dtype=torch.float64).to(dtype)  # noqa: E731
    return rand(b, t, 2 * m), rand(b, f, 2 * m), rand(2 * m) * 0.3, rand(2 * m) * 0.3


def _eager_gate(y, c, b_dil, b_cond):
    """The original block's expression (models/wavenet_ae.py)."""
    d = condition(y + b_dil, c + b_cond)
    m = d.shape[2] // 2
    return torch.sigmoid(d[:, :, :m]) * torch.tanh(d[:, :, m:])


def _rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float64])
def test_gate_forward_equals_the_eager_expression(shape, dtype):
    args = _gate_inputs(shape, dtype)
    got = decoder.gate_fwd(*args)
    assert got.dtype == dtype and torch.equal(got, _eager_gate(*args))
    assert torch.equal(decoder.decoder_gate(*args), got)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gate_backward_formulas_match_autograd(shape, dtype):
    """dz, dc (the sum of dz over each frame's rows) and the bias gradients
    (dc's sums over batch and frames) against autograd of the eager gate."""
    args = [a.requires_grad_(True) for a in _gate_inputs(shape, dtype)]
    dgated = torch.randn(_eager_gate(*args).shape, dtype=torch.float64,
                         generator=torch.Generator().manual_seed(1)).to(dtype)
    want = torch.autograd.grad(_eager_gate(*args), args, dgated)
    dz, dc = decoder.gate_bwd(*[a.detach() for a in args], dgated)
    assert dz.dtype == dtype and dc.dtype == dtype  # float32 sums: float32 or float64
    db = dc.sum((0, 1))
    for name, a, b in (("dz", dz, want[0]), ("dc", dc, want[1]), ("db_dil", db, want[2]),
                       ("db_cond", db, want[3])):
        assert _rel(a, b) <= GRAD_TOL[dtype], name
    got = torch.autograd.grad(decoder.decoder_gate(*args), args, dgated)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and _rel(a, b) <= GRAD_TOL[dtype]


def test_gate_backward_rounds_where_the_eager_bf16_backward_rounds():
    """bfloat16: dz equals autograd of the eager gate bit for bit (each
    product with the incoming gradient and each activation's gradient rounded
    once); dc and the biases' gradients are float32 sums, within one bf16
    step of the eager bf16 sums."""
    args = [a.requires_grad_(True) for a in _gate_inputs(SHAPES[0], torch.bfloat16)]
    dgated = torch.randn((2, 12, 8), generator=torch.Generator().manual_seed(2)).bfloat16()
    want = torch.autograd.grad(_eager_gate(*args), args, dgated)
    got = torch.autograd.grad(decoder.decoder_gate(*args), args, dgated)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == torch.bfloat16 and _rel(a, b) <= 2 ** -7


@pytest.mark.parametrize("shape", SHAPES)
def test_gate_gradcheck(shape):
    args = [a.requires_grad_(True) for a in _gate_inputs(shape, torch.float64)]
    assert torch.autograd.gradcheck(decoder.decoder_gate, args)


def _residual_inputs(dtype, b=2, t=6, cl=8, cs=4, seed=3):
    g = torch.Generator().manual_seed(seed)
    rand = lambda *s: torch.randn(s, generator=g, dtype=torch.float64).to(dtype)  # noqa: E731
    return rand(b, t, cl), rand(b, t, cs), rand(b, t, cl), rand(b, t, cs), rand(cl), rand(cs)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float64])
def test_residual_forward_equals_the_eager_expression(dtype):
    l, s, r, k, b_res, b_skip = _residual_inputs(dtype)
    got = decoder.decoder_residual(l, s, r, k, b_res, b_skip)
    assert torch.equal(got[0], l + (r + b_res)) and torch.equal(got[1], s + (k + b_skip))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_residual_backward_matches_autograd(dtype):
    args = [a.requires_grad_(True) for a in _residual_inputs(dtype)]
    l, s, r, k, b_res, b_skip = args
    g = [torch.randn(a.shape, dtype=torch.float64).to(dtype) for a in (l, s)]
    want = torch.autograd.grad((l + (r + b_res), s + (k + b_skip)), args, g)
    got = torch.autograd.grad(decoder.decoder_residual(*args), args, g)
    assert got[0] is got[2] and got[1] is got[3]  # passed on, no copy
    for a, b in zip(got, want):
        assert _rel(a, b) <= GRAD_TOL[dtype]


def test_residual_gradcheck():
    args = [a.requires_grad_(True) for a in _residual_inputs(torch.float64)]
    assert torch.autograd.gradcheck(decoder.decoder_residual, args)


def test_an_unused_residual_output_sends_no_gradient():
    """Only s' reaches the loss (the last block's l' feeds nothing): l, r and
    b_res get no gradient, so the res product runs no backward."""
    args = [a.requires_grad_(True) for a in _residual_inputs(torch.float32)]
    _, s_out = decoder.decoder_residual(*args)
    grads = torch.autograd.grad(s_out.sum(), args, allow_unused=True)
    assert grads[0] is None and grads[2] is None and grads[4] is None
    assert torch.equal(grads[5], torch.full((4,), 12.0))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_an_unused_residual_output_runs_no_product_backward(dtype, monkeypatch):
    """The bf16 products on the card are ``_MergedTapsConv``: when l' reaches
    no loss the residual sends r no gradient, and the res product's backward
    does not run (its weight gets none), as on the plain route."""
    from audio_style_transfer_tpu_torch.ops import conv

    calls = []
    backward = conv._MergedTapsConv.backward
    monkeypatch.setattr(conv._MergedTapsConv, "backward",
                        staticmethod(lambda ctx, g: calls.append(g is None) or backward(ctx, g)))
    l, s, gated, k, b_res, b_skip = _residual_inputs(dtype)
    w = torch.randn((1, 8, 8), dtype=torch.float64).to(dtype).requires_grad_(True)
    r = conv._MergedTapsConv.apply(gated, w, [0])
    _, s_out = decoder.decoder_residual(l, s, r, k.requires_grad_(True), b_res, b_skip)
    s_out.float().sum().backward()
    assert w.grad is None and calls in ([], [True])
    assert k.grad is not None


def test_wrappers_refuse_a_ragged_t_mixed_devices_and_bad_shapes():
    y, c, b_dil, b_cond = _gate_inputs((2, 12, 3, 8), torch.float32)
    with pytest.raises(ValueError, match="multiple of the frame count"):
        decoder.gate_fwd(y[:, :10], c, b_dil, b_cond)
    with pytest.raises(ValueError, match="multiple of the frame count"):
        decoder.gate_bwd(y[:, :10], c, b_dil, b_cond, y[:, :10, :8])
    with pytest.raises(ValueError, match="dgated"):
        decoder.gate_bwd(y, c, b_dil, b_cond, y[..., :4])
    with pytest.raises(ValueError, match="one device"):
        decoder.gate_fwd(y, c.to("meta"), b_dil, b_cond)
    with pytest.raises(ValueError, match="biases"):
        decoder.gate_fwd(y, c, b_dil[:8], b_cond)
    l, s, r, k, b_res, b_skip = _residual_inputs(torch.float32)
    with pytest.raises(ValueError, match="one device"):
        decoder.residual_fwd(l, s, r, k.to("meta"), b_res, b_skip)
    with pytest.raises(ValueError, match="one device"):
        decoder.residual_bwd(l, s.to("meta"))
    with pytest.raises(ValueError):
        decoder.residual_fwd(l, s, r[:, :5], k, b_res, b_skip)
    with pytest.raises(ValueError):
        decoder.residual_bwd(l, s[:, :5])


# A narrow decoder; biases drawn nonzero so that every bias path carries a value.
BLOCK_CFG = dict(num_layers=2, num_stages=2, width=16, skip_width=8, ae_hop_length=4,
                 ae_bottleneck_width=4)
BLOCK_TOL = {torch.float64: 1e-12, torch.float32: 1e-5, torch.bfloat16: 2 ** -7}


def _block_grads(block, cfg, params, l, s, enc, remat, layer=2):
    ps = {k: {m: v.clone().requires_grad_(True) for m, v in e.items()} for k, e in params.items()}
    li, si, ei = (x.clone().requires_grad_(True) for x in (l, s, enc))
    names = (f"dilatedconv_{layer}", f"cond_map_{layer}", f"res_{layer}", f"skip_{layer}")
    args = (cfg, layer, li, si, *(ps[n] for n in names), ei)
    if remat:
        lo, so = torch.utils.checkpoint.checkpoint(block, *args, use_reentrant=False)
    else:
        lo, so = block(*args)
    weights = torch.linspace(-1, 1, lo.numel(), dtype=torch.float64).reshape(lo.shape)
    ((lo.double() * weights).sum() + (so.double() ** 2).sum()).backward()
    leaves = [li, si, ei] + [ps[n][m] for n in names for m in ("w", "b")]
    return lo.detach(), so.detach(), [x.grad for x in leaves]


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float64])
def test_fused_block_matches_the_plain_block(dtype, remat):
    """The fused route of a block (the products without their biases, the
    gate and the residual Functions) against the plain block: the outputs bit
    for bit in every dtype, every gradient within rounding of the sums (bf16:
    one bf16 step; the biases' float32 sums round once where the plain path's
    bf16 sums round twice)."""
    cfg = wavenet_ae.WaveNetAEConfig(**BLOCK_CFG, compute_dtype=dtype)
    params = wavenet_ae.init_params(0, cfg)
    gen = torch.Generator().manual_seed(5)
    for e in params.values():
        e["b"].uniform_(-0.3, 0.3, generator=gen)
    l, s = torch.randn((2, 12, 16), generator=gen), torch.randn((2, 12, 8), generator=gen)
    enc = torch.randn((2, 3, 4), generator=gen)
    outs = [_block_grads(block, cfg, params, l.to(dtype), s.to(dtype), enc.to(dtype), remat)
            for block in (wavenet_ae._fused_decoder_block, wavenet_ae._plain_decoder_block)]
    (lf, sf, gf), (lp, sp, gp) = outs
    assert torch.equal(lf, lp) and torch.equal(sf, sp)
    for a, b in zip(gf, gp):
        assert a.dtype == b.dtype and _rel(a, b) <= BLOCK_TOL[dtype]


def test_decode_logits_of_cpu_tensors_runs_the_plain_block(monkeypatch):
    """CPU tensors never reach the fused route: decode_logits with a remat
    backward calls the plain block once a layer per forward."""
    calls = []
    plain = wavenet_ae._plain_decoder_block
    monkeypatch.setattr(wavenet_ae, "_plain_decoder_block",
                        lambda *a: calls.append(a[1]) or plain(*a))
    monkeypatch.setattr(wavenet_ae, "_fused_decoder_block", None)
    cfg = dataclasses.replace(wavenet_ae.WaveNetAEConfig(**BLOCK_CFG), remat=True)
    params = wavenet_ae.init_params(0, cfg)
    for e in params.values():
        e["w"].requires_grad_(True)
    xq = torch.floor(torch.rand((1, 8), generator=torch.Generator().manual_seed(0)) * 256 - 128)
    logits = wavenet_ae.decode_logits(params, xq, torch.zeros((1, 2, 4)), cfg)
    logits.sum().backward()
    assert calls == [1, 2, 2, 1]  # the forward, then each block's recompute in reverse
