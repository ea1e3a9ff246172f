"""ops/conv.py's merged-taps operand: out[b, t, k*C + c] = x[b, t + o_k, c],
zero off the clip.

On the CPU: ``_side_by_side`` takes the plain pad and concatenation, equal
to that formula, and never loads the kernel library; ``taps_pack`` refuses
what the kernel does not take before it loads anything. On the card (marked
``cuda``, skipped here): the pack kernel (csrc/conv.cu) against the plain
route bit for bit, the bf16 conv and its gradients bit for bit the plain
route's, the launches of a remat training step, and the refusals. Run them
with ``python -m pytest tests/test_torch_taps_pack.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from audio_style_transfer_tpu_torch.ops import _build, conv

# Dilations: neighbours, a few rows, the decoder's longest, and one whose span
# exceeds the card tests' T = 2047 so that a whole tap reads nothing.
CARD_T = 2047
DILATIONS = [1, 4, 512, 2100]


def _want(x: torch.Tensor, offsets) -> torch.Tensor:
    """The formula, element by element through numpy indexing."""
    a = x.float().numpy()
    b, t, c = a.shape
    out = np.zeros((b, t, len(offsets) * c), np.float32)
    for k, o in enumerate(offsets):
        rows = np.arange(t) + o
        inside = (rows >= 0) & (rows < t)
        out[:, inside, k * c:(k + 1) * c] = a[:, rows[inside]]
    return torch.from_numpy(out).to(x.dtype)


def _plain(x: torch.Tensor, offsets) -> torch.Tensor:
    """The route every tensor took before the kernel: pad, then concatenate."""
    return x if offsets == [0] else torch.cat(conv._shifted_by(x, offsets), dim=-1)


@pytest.fixture
def no_library(monkeypatch):
    """Fail on any load of the kernel library; the launch count must stay."""
    def refuse():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(_build, "lib", refuse)
    before = _build.LAUNCHES["taps_pack"]
    yield
    assert _build.LAUNCHES["taps_pack"] == before


@pytest.mark.parametrize("negated", [False, True])
@pytest.mark.parametrize("d", [1, 4, 30, 100])
@pytest.mark.parametrize("f", [2, 3])
@pytest.mark.parametrize("causal", [True, False])
def test_cpu_side_by_side_is_the_plain_route_and_the_formula(causal, f, d, negated, no_library):
    """T = 50: d = 100 puts whole taps off the clip; two clips, so a tap
    never reads the neighbouring clip's rows."""
    offsets = conv._offsets(f, d, causal)
    if negated:
        offsets = [-o for o in offsets]
    x = torch.randn((2, 50, 8), generator=torch.Generator().manual_seed(d + f)).to(torch.bfloat16)
    got = conv._side_by_side(x, offsets)
    assert got.dtype == x.dtype and got.shape == (2, 50, f * 8)
    assert torch.equal(got, _want(x, offsets))
    assert torch.equal(got, _plain(x, offsets))


def test_cpu_one_tap_is_x_itself(no_library):
    x = torch.randn((2, 16, 8))
    assert conv._side_by_side(x, [0]) is x


def test_cpu_merged_taps_conv_takes_strided_inputs_and_cotangents(no_library):
    """``_MergedTapsConv`` copies a strided input and an expanded cotangent
    (the gradient of a sum) to contiguous rows before it packs them: float64
    on the CPU, against autograd of the conv summed tap by tap."""
    g = torch.Generator().manual_seed(3)
    w = torch.randn((3, 6, 5), generator=g, dtype=torch.float64)
    for f, d, causal in ((3, 2, True), (3, 5, False), (2, 3, True)):
        x = torch.randn((2, 40, 12), generator=g, dtype=torch.float64).requires_grad_(True)
        wf = w[:f].clone().requires_grad_(True)
        xs = x[:, :, ::2]  # [2, 40, 6], every other channel
        assert not xs.is_contiguous()
        y = conv._MergedTapsConv.apply(xs, wf, conv._offsets(f, d, causal))
        got = torch.autograd.grad(y.sum(), [x, wf])
        want_y = sum(xk @ wf[k] for k, xk in enumerate(conv._shifted(xs, f, d, causal)))
        want = torch.autograd.grad(want_y.sum(), [x, wf])
        assert torch.allclose(y, want_y, rtol=1e-12, atol=1e-12)
        for a, b in zip(got, want):
            assert torch.allclose(a, b, rtol=1e-12, atol=1e-12)


REFUSALS = {  # name: (x, offsets, exception, words of the message)
    "float32": (lambda: torch.zeros((1, 16, 8)), [-1, 0], TypeError, "bfloat16"),
    "strided": (lambda: torch.zeros((1, 16, 16), dtype=torch.bfloat16)[:, :, ::2], [-1, 0],
                ValueError, "contiguous"),
    "width": (lambda: torch.zeros((1, 16, 12), dtype=torch.bfloat16), [-1, 0], ValueError,
              "multiple of 8"),
    "rank": (lambda: torch.zeros((16, 8), dtype=torch.bfloat16), [-1, 0], ValueError, "[B, T, C]"),
    "one tap": (lambda: torch.zeros((1, 16, 8), dtype=torch.bfloat16), [0], ValueError,
                "evenly spaced"),
    "uneven": (lambda: torch.zeros((1, 16, 8), dtype=torch.bfloat16), [-3, 0, 1], ValueError,
               "evenly spaced"),
    "cpu": (lambda: torch.zeros((1, 16, 8), dtype=torch.bfloat16), [-1, 0], RuntimeError,
            "CUDA tensors"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_cpu_taps_pack_refuses_before_it_loads_the_library(name, no_library):
    make, offsets, exc, words = REFUSALS[name]
    with pytest.raises(exc, match=words.replace("[", r"\[").replace("]", r"\]")):
        conv.taps_pack(make(), offsets)


# --- on the card -------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pack kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("negated", [False, True])
@pytest.mark.parametrize("d", DILATIONS)
@pytest.mark.parametrize("f", [2, 3])
@pytest.mark.parametrize("causal", [True, False])
def test_pack_equals_the_plain_route_bit_for_bit(dev, causal, f, d, negated):
    """T = 2047 (no power of two), C in {128, 512, 1024}, B in {1, 2}: one
    launch each, the plain pad and concatenation's bits."""
    offsets = conv._offsets(f, d, causal)
    if negated:
        offsets = [-o for o in offsets]
    gen = torch.Generator(device=dev).manual_seed(f * 10000 + d)
    for c in (128, 512, 1024):
        for b in (1, 2):
            x = torch.randn((b, CARD_T, c), generator=gen, device=dev).to(torch.bfloat16)
            before = _build.LAUNCHES["taps_pack"]
            got = conv._side_by_side(x, offsets)
            torch.cuda.synchronize()
            assert _build.LAUNCHES["taps_pack"] == before + 1
            assert got.shape == (b, CARD_T, f * c) and got.is_contiguous()
            assert torch.equal(got, _plain(x, offsets)), (c, b)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("f,d,cin,cout",
                         [(3, 4, 512, 1024), (3, 512, 128, 128), (2, 3, 1024, 512)])
def test_bf16_conv_and_its_gradients_are_the_plain_routes_bits(dev, monkeypatch, causal, f, d,
                                                               cin, cout):
    """y, dx and dw of ``conv1d`` on bf16 CUDA tensors: the pack kernel's
    route against the same products over the plain pad and concatenation
    (``_side_by_side`` swapped for it), bit for bit; two packs, the forward
    and the input gradient."""
    gen = torch.Generator(device=dev).manual_seed(cin + d)
    bf16 = torch.bfloat16
    x = torch.randn((2, 2048, cin), generator=gen, device=dev).to(bf16)
    w = (torch.randn((f, cin, cout), generator=gen, device=dev) * cin ** -0.5).to(bf16)
    g = torch.randn((2, 2048, cout), generator=gen, device=dev).to(bf16)
    out = {}
    for route in ("kernel", "plain"):
        if route == "plain":
            monkeypatch.setattr(conv, "_side_by_side", _plain)
        before = _build.LAUNCHES["taps_pack"]
        xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y = conv.conv1d(xr, wr, None, dilation=d, causal=causal)
        dx, dw = torch.autograd.grad(y, [xr, wr], g)
        torch.cuda.synchronize()
        out[route] = (y.detach(), dx, dw, _build.LAUNCHES["taps_pack"] - before)
    assert out["kernel"][3] == 2 and out["plain"][3] == 0
    for name, a, b in zip(("y", "dx", "dw"), out["kernel"][:3], out["plain"][:3]):
        assert a.dtype == bf16 and torch.equal(a, b), name


@pytest.mark.cuda
def test_bf16_conv_takes_a_strided_input_and_an_expanded_cotangent(dev):
    """A strided input (every other channel) and the expanded cotangent of a
    sum reach the pack as contiguous copies: the same bits as from
    contiguous copies made by hand."""
    gen = torch.Generator(device=dev).manual_seed(5)
    wide = torch.randn((2, 2048, 256), generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((3, 128, 128), generator=gen, device=dev) * 128 ** -0.5).to(torch.bfloat16)
    grads = []
    for x in (wide[:, :, ::2], wide[:, :, ::2].contiguous()):
        xr, wr = x.detach().requires_grad_(True), w.clone().requires_grad_(True)
        y = conv.conv1d(xr, wr, None, dilation=8, causal=True)
        grads.append((y.detach(), *torch.autograd.grad(y.sum(), [xr, wr])))
    torch.cuda.synchronize()
    for name, a, b in zip(("y", "dx", "dw"), *grads):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_remat_training_step_packs_each_dilated_conv(dev):
    """One bf16 ``train_loss`` backward with remat, 4 decoder layers of 6
    encoder layers, T = 2048: each decoder dilated conv packs in the forward,
    and in the backward in the re-forward and for the input gradient (3 a
    layer); the trunk's weight recompute (``ops/chain.py::TrunkFunction``)
    runs the encoder's 3-tap convs through ``conv1d``, which packs each
    input and every cotangent but the first layer's, whose input needs no
    gradient (2 a layer less 1). The 1x1 convs and the one-channel start
    conv pack nothing."""
    from audio_style_transfer_tpu_torch.models import wavenet_ae
    from audio_style_transfer_tpu_torch.train.trainer import train_loss

    layers, ae_layers = 4, 6
    cfg = wavenet_ae.WaveNetAEConfig(
        num_layers=layers, num_stages=2, width=64, skip_width=32, ae_num_layers=ae_layers,
        ae_num_stages=3, ae_hop_length=64, ae_bottleneck_width=8, compute_dtype=torch.bfloat16,
        remat=True)
    params = wavenet_ae.init_params(0, cfg, device=dev)
    wav = torch.tensor(np.random.RandomState(0).uniform(-0.8, 0.8, (2, 2048)),
                       dtype=torch.float32, device=dev)
    leaves = [v.requires_grad_(True) for e in params.values() for v in e.values()]
    before = _build.LAUNCHES["taps_pack"]
    loss = train_loss(params, wav, cfg)
    assert _build.LAUNCHES["taps_pack"] - before == layers  # the forward, under checkpoint
    torch.autograd.grad(loss, leaves, allow_unused=True)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["taps_pack"] - before == 3 * layers + 2 * ae_layers - 1


@pytest.mark.cuda
def test_pack_refuses_what_the_kernel_does_not_take_on_the_card(dev):
    """A float32, a strided and a 12-channel CUDA tensor raise; nothing is
    launched and nothing falls back."""
    bf16 = torch.bfloat16
    cases = (
        (torch.zeros((1, 64, 8), device=dev), TypeError, "bfloat16"),
        (torch.zeros((1, 64, 16), dtype=bf16, device=dev)[:, :, ::2], ValueError, "contiguous"),
        (torch.zeros((1, 64, 12), dtype=bf16, device=dev), ValueError, "multiple of 8"),
        (torch.zeros((520,), dtype=bf16, device=dev)[4:516].view(1, 64, 8), ValueError,
         "aligned"),
    )
    before = _build.LAUNCHES["taps_pack"]
    for x, exc, words in cases:
        with pytest.raises(exc, match=words):
            conv._side_by_side(x, [-2, -1, 0])
    assert _build.LAUNCHES["taps_pack"] == before
