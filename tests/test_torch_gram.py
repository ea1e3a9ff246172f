"""Port gram (ops/gram.py) vs the JAX all-pairs gram (Pallas, interpret mode).

On the CPU the port's forward runs its plain einsum and the backward the
plain composition; JAX runs its forward kernel, and its backward kernel (K6)
for L > 15 (the L=16, 18 and 30 cases) and for T > 32768, in interpret mode.
f32, T=256, C=16 (C=8 past the T gate). The port has no such threshold: a
CPU tensor takes the plain composition and any other tensor
``pair_gram_bwd`` (K6), at every L and T. The kernels' launch geometry (tap
bucket, rows per block, scratch shape) is plain Python and is held here too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import interpret_mode, n, t  # noqa: F401

from audio_style_transfer_tpu.ops.pallas_gram import pair_gram as jax_pair_gram
from audio_style_transfer_tpu_torch.ops import _build, gram

# Sums of 256 float32 products taken in different orders.
RTOL, ATOL = 1e-5, 1e-5


def _taps(nl, b=1, tl=256, c=16, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, tl, c).astype(np.float32) for _ in range(nl)]


@pytest.mark.usefixtures("interpret_mode")
@pytest.mark.parametrize("nl", [3, 10, 16, 18, 30])
def test_forward_and_grad_match_jax(nl):
    taps = _taps(nl)
    ct = np.random.RandomState(7).randn(1, nl, nl, 16).astype(np.float32)

    want = jax_pair_gram(*[jnp.asarray(a) for a in taps])
    want_grads = jax.grad(
        lambda *ts: jnp.sum(jax_pair_gram(*ts) * ct), argnums=tuple(range(nl))
    )(*[jnp.asarray(a) for a in taps])

    tt = [t(a).requires_grad_(True) for a in taps]
    got = gram.pair_gram(*tt)
    assert got.shape == (1, nl, nl, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(n(got), n(want), rtol=RTOL, atol=ATOL)
    grads = torch.autograd.grad(got, tt, t(ct))
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(n(g), n(w), rtol=RTOL, atol=ATOL)


@pytest.mark.usefixtures("interpret_mode")
def test_backward_past_the_t_gate_matches_jax():
    """L=2 but T > 32768: JAX runs its backward kernel there too."""
    tl = 32768 + 128
    taps = _taps(2, tl=tl, c=8, seed=3)
    ct = np.random.RandomState(8).randn(1, 2, 2, 8).astype(np.float32)
    want = jax.grad(lambda a, b: jnp.sum(jax_pair_gram(a, b) * ct), argnums=(0, 1))(
        *[jnp.asarray(a) for a in taps])
    tt = [t(a).requires_grad_(True) for a in taps]
    got = torch.autograd.grad(gram.pair_gram(*tt), tt, t(ct))
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g), n(w), rtol=RTOL, atol=ATOL * float(np.abs(n(w)).max()))


@pytest.mark.parametrize("nl,tl", [(15, 64), (16, 64), (2, 32768), (2, 32769)])
def test_backward_routing_follows_jax(nl, tl):
    """Either side of JAX's threshold (pallas_gram.py _vjp_bwd: L <= 15 and
    T <= 32768) a CPU tensor gets the plain composition's gradient and
    launches no kernel: the port routes by the tensor's device alone."""
    _build.reset_launches()
    tt = [t(a).requires_grad_(True) for a in _taps(nl, tl=tl, c=8)]
    grads = torch.autograd.grad(gram.pair_gram(*tt).sum(), tt)
    assert not any(_build.LAUNCHES.values()), _build.LAUNCHES
    want = gram.pair_gram_bwd_plain([x.detach() for x in tt],
                                    torch.full((1, nl, nl, 8), 2.0))
    for g, w in zip(grads, want):
        np.testing.assert_allclose(n(g), n(w), rtol=RTOL, atol=ATOL)


def test_backward_of_a_tensor_off_the_cpu_goes_to_the_kernel_wrapper(monkeypatch):
    """L=10 (the stack-0 tap count, inside JAX's plain range): the backward of
    taps that do not lie on the CPU calls ``pair_gram_bwd`` with h = g + g^T
    and never the plain composition."""
    calls = []

    def fake_bwd(taps, h):
        calls.append((len(taps), h.device.type, h.dtype, tuple(h.shape)))
        return tuple(torch.empty_like(tp) for tp in taps)

    def no_plain(taps, h):
        raise AssertionError("the plain composition ran on a tensor off the CPU")

    monkeypatch.setattr(gram, "pair_gram_fwd",
                        lambda *taps: torch.empty((1, len(taps), len(taps), 8), device="meta"))
    monkeypatch.setattr(gram, "pair_gram_bwd", fake_bwd)
    monkeypatch.setattr(gram, "pair_gram_bwd_plain", no_plain)
    tt = [torch.empty((1, 64, 8), device="meta", requires_grad=True) for _ in range(10)]
    grads = torch.autograd.grad(gram.pair_gram(*tt).sum(), tt)
    assert calls == [(10, "meta", torch.float32, (1, 10, 10, 8))]
    assert all(g.shape == (1, 64, 8) for g in grads)


@pytest.mark.parametrize("nl,bucket", [(1, 8), (8, 8), (9, 16), (10, 16), (16, 16), (17, 24),
                                       (24, 24), (25, 32), (30, 32), (32, 32)])
def test_tap_bucket_rounds_up_to_eight(nl, bucket):
    assert gram.tap_bucket(nl) == bucket
    assert bucket in gram.BWD_RESIDENT


@pytest.mark.parametrize("nl", [0, 33])
def test_tap_bucket_refuses_what_a_launch_cannot_take(nl):
    with pytest.raises(ValueError, match="1..32 taps"):
        gram.tap_bucket(nl)


# (B, T, C, SMs) -> rows: the main path, two clips, a narrow C, a short and
# a ragged T, more channel groups than SMs.
@pytest.mark.parametrize("b,tl,c,sms,rows", [
    (1, 16384, 128, 132, 2048), (2, 16384, 128, 132, 4096), (1, 16384, 32, 132, 497),
    (1, 100, 128, 132, 256), (1, 16392, 128, 132, 2049), (16, 16384, 128, 132, 16384)])
def test_forward_chunk_rows_make_about_one_block_an_sm(b, tl, c, sms, rows):
    got = gram.fwd_chunk_rows(b, tl, c, sms)
    assert got == rows
    chunks = -(-tl // got)
    blocks = b * (c // gram.CHANNEL_BLOCK) * chunks
    assert blocks <= max(sms, b * (c // gram.CHANNEL_BLOCK))
    assert gram.fwd_scratch_shape(b, tl, c, 30, got) == (b, chunks, 465, c)


def test_forward_scratch_stays_under_two_megabytes_on_the_main_path():
    """[B, chunks, pairs, C] float32 at L=30, T=16384, C=128 on 132 SMs."""
    rows = gram.fwd_chunk_rows(1, 16384, 128, 132)
    shape = gram.fwd_scratch_shape(1, 16384, 128, 30, rows)
    assert shape == (1, 8, 465, 128)
    assert 4 * int(np.prod(shape)) < 2e6


@pytest.mark.parametrize("b,tl,c,nl,sms", [
    (1, 16384, 128, 30, 132), (1, 16384, 128, 10, 132), (2, 16392, 128, 17, 132),
    (1, 1, 16, 1, 132), (2, 1000, 32, 8, 132), (64, 4096, 128, 32, 132)])
def test_backward_block_rows_fill_one_wave(b, tl, c, nl, sms):
    rows = gram.bwd_block_rows(b, tl, c, nl, sms)
    assert rows % gram.BWD_STEP == 0 and rows >= gram.MIN_ROWS
    groups = b * (c // gram.BWD_CHANNEL_BLOCK)
    slots = sms * gram.BWD_RESIDENT[gram.tap_bucket(nl)]
    blocks = groups * -(-tl // rows)
    # One wave, unless the channel groups alone exceed it.
    assert blocks <= max(slots, groups)
    # And no coarser than that asks for: one step fewer would overflow the
    # wave, or the floor of MIN_ROWS holds.
    finer = rows - gram.BWD_STEP
    assert rows == gram.MIN_ROWS or groups * -(-tl // finer) > slots


def test_backward_block_rows_on_the_main_path():
    assert gram.bwd_block_rows(1, 16384, 128, 30, 132) == 512
    assert gram.bwd_block_rows(1, 16384, 128, 10, 132) == 256


def test_cpu_path_launches_no_kernel():
    _build.reset_launches()
    tt = [t(a).requires_grad_(True) for a in _taps(30, tl=64, c=8)]
    torch.autograd.grad(gram.pair_gram(*tt).sum(), tt)
    assert not any(_build.LAUNCHES.values()), _build.LAUNCHES


def test_batched_and_bf16_products_in_f32():
    """Batch rows are independent grams; bf16 taps are multiplied in f32
    (bf16 x bf16 products are exact in f32), so they match the f32 gram of
    the bf16-rounded taps."""
    taps = _taps(4, b=2)
    bf = [t(a, torch.bfloat16) for a in taps]
    got = gram.pair_gram(*bf)
    want = gram.pair_gram_reference(*[b.float() for b in bf])
    np.testing.assert_allclose(n(got), n(want), rtol=RTOL, atol=ATOL)
    for b in range(2):
        single = gram.pair_gram(*[tp[b : b + 1] for tp in bf])
        np.testing.assert_allclose(n(got[b]), n(single[0]), rtol=RTOL, atol=ATOL)
    g = torch.autograd.grad(gram.pair_gram(*[tp.requires_grad_(True) for tp in bf]).sum(), bf)
    assert all(x.dtype == torch.bfloat16 for x in g)


def test_kernel_checks_raise_on_bad_input():
    meta = [torch.zeros((1, 64, 24), device="meta") for _ in range(2)]
    with pytest.raises(RuntimeError, match="CUDA"):
        gram.pair_gram_fwd(*meta)
    with pytest.raises(RuntimeError, match="CUDA"):
        gram.pair_gram_bwd(meta, torch.zeros((1, 2, 2, 24), device="meta"))
