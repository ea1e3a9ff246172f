"""The grouped wavefront trunk backward (K2-wf) of the port on the CPU: its
plan, its plain version's schedule, and the trunk gradient with the switch on
against the JAX wavefront kernel (Pallas, interpret mode).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import interpret_mode, n, t, trunk_inputs  # noqa: F401

from audio_style_transfer_tpu.ops import pallas_chain as jchain
from audio_style_transfer_tpu_torch.ops import _build, chain

FULL_DILS = tuple(2 ** (i % 10) for i in range(30))


@pytest.fixture
def jax_wavefront(monkeypatch):
    """Route the JAX backward through ``_bwd_group_kernel_wf`` and clear the
    plan and trace caches that captured the serial estimate."""
    monkeypatch.setattr(jchain, "_BWD_WAVEFRONT", True)
    jchain.plan_groups.cache_clear()
    jchain._make_trunk.cache_clear()
    yield
    jchain.plan_groups.cache_clear()
    jchain._make_trunk.cache_clear()


@pytest.fixture
def port_wavefront(monkeypatch):
    monkeypatch.setattr(chain, "_BWD_WAVEFRONT", True)


def _group_inputs(dils, rows, c, dtype, seed=0, missing=()):
    rng = np.random.RandomState(seed)
    k = len(dils)
    wd = t(rng.randn(k, 3, c, c) * 0.2, dtype)
    wr = t(rng.randn(k, c, c) * 0.2, dtype)
    dxn = t(rng.randn(rows, c), dtype)
    dtaps = [None if j in missing else t(rng.randn(rows, c), dtype) for j in range(k)]
    masks = [torch.tensor(rng.randint(0, 4, (rows, c)), dtype=torch.uint8) for _ in range(k)]
    inmask = torch.tensor(rng.randint(0, 2, (rows, c)), dtype=torch.uint8)
    return dxn, dtaps, masks, inmask, wd, wr


@pytest.mark.parametrize("dils,tile", [((1, 2, 4, 8), 64), ((1, 2, 4, 8), 32),
                                       ((1, 2, 4), 64), ((2, 4), 64), ((8, 4, 2, 1), 64)])
def test_splits_recede_by_d_and_stay_in_the_producible_range(dils, tile):
    splits = chain.wavefront_splits(dils, tile)
    assert splits is not None
    k, nk = len(dils), sum(dils)
    prefix = np.concatenate([[0], np.cumsum(dils)])
    assert splits[k - 1] == nk + tile // 2
    for s in range(k):
        j = k - 1 - s
        d = dils[j]
        lo, hi = nk - prefix[j], nk + tile + prefix[j]
        # Both halves are non-empty, and the dy rows a piece needs (d either
        # side of its output) lie in the rows layer j+1 produced.
        assert lo < splits[s] < hi
        assert lo - d >= nk - prefix[j + 1] and hi + d <= nk + tile + prefix[j + 1]
        assert splits[s] - d >= nk - prefix[j + 1] and splits[s] + d <= nk + tile + prefix[j + 1]
        if s + 1 < k:
            # A_{s+1} reads d_{s+1} rows past its output: exactly up to split[s].
            assert splits[s] - splits[s + 1] == dils[j - 1]


@pytest.mark.parametrize("dils,tile", [((16, 32), 64), ((256,) * 2, 64), ((1, 2, 4, 8), 256),
                                       ((32, 1), 64)])
def test_infeasible_groups_have_no_splits(dils, tile):
    assert chain.wavefront_splits(dils, tile) is None


@pytest.mark.parametrize("itemsize,tile", [(4, 32)])
def test_full_geometry_plan(itemsize, tile):
    """The FMA K2-wf's plan, float32's: 30 layers, dilations 2**(i % 10),
    T=16384: the four layers with d <= 8 of each stack form one group at tile
    32, where three carry slots of a 64-row tile would not fit a block's
    shared memory; the other 18 layers stay single K2 launches."""
    plan = chain.plan_bwd_groups(FULL_DILS, 16384, itemsize)
    groups = [g for g in plan if g.splits is not None]
    assert [(g.j0, g.dils, g.tile) for g in groups] == [
        (j0, (1, 2, 4, 8), tile) for j0 in (0, 10, 20)]
    singles = [g.j0 for g in plan if g.splits is None]
    assert singles == [j for j in range(30) if j % 10 >= 4]
    assert all(len(g.dils) == 1 for g in plan if g.splits is None)
    for g in groups:
        assert chain.wavefront_smem_bytes(g.dils, g.tile, itemsize) <= chain.SMEM_PER_BLOCK
    assert chain.wavefront_smem_bytes((1, 2, 4, 8), 64, 4) > chain.SMEM_PER_BLOCK
    assert sum(len(g.dils) for g in plan) == 30


@pytest.mark.parametrize("rows", [16384, 40960, 237568])
def test_tensor_core_plan_takes_the_same_layers_at_tile_128(rows):
    """The bf16 plan is the tensor-core K2-wf's: at the engine's clip (16384
    rows), the exact scan's halo-extended window (40960) and the 15 s single
    window (237568) the same three groups of dilations (1, 2, 4, 8) as the
    FMA plan, at tile 128 (220,160 B of shared memory: four resident weights
    and two buffers of 158 + 16 rows), so an evaluation still launches 3
    K2-wf and 18 K2. Its splits order only the plain version's pieces: they
    exceed the FMA kernel's 80-row dy buffer."""
    plan = chain.plan_bwd_groups(FULL_DILS, rows, 2)
    groups = [g for g in plan if g.splits is not None]
    assert [(g.j0, g.dils, g.tile) for g in groups] == [
        (j0, (1, 2, 4, 8), 128) for j0 in (0, 10, 20)]
    assert [g.j0 for g in plan if g.splits is None] == [j for j in range(30) if j % 10 >= 4]
    for g in groups:
        assert chain.wavefront_mma_smem_bytes(g.dils, g.tile) == 220160
        assert chain.wavefront_mma_fits(g.dils, g.tile)
        assert g.splits == chain.wavefront_splits(g.dils, 128, None)
        assert chain.wavefront_splits(g.dils, 128) is None


@pytest.mark.parametrize("dils,tile,fits", [
    ((1, 2, 4, 8), 128, True), ((8, 4, 2, 1), 128, True), ((1, 2, 4), 128, True),
    ((2, 4), 128, True), ((1, 2, 4, 8), 64, True),
    ((16, 32), 128, False),  # shared memory: 253,952 B
    ((2, 4, 8, 16), 128, False),  # shared memory: 235,520 B
    ((8, 9, 1), 128, False),  # the first step's 162 output rows: 11 fragments, 10 warps
    ((1, 2, 4, 8), 120, False),  # not a whole number of 16-row fragments
])
def test_tensor_core_geometry(dils, tile, fits):
    """What the tensor-core K2-wf takes, as csrc/trunk_wf_mma.cu::feasible
    checks it: no dy-row limit (it does not split a step), 16-row fragments,
    at most one fragment a warp in the first step's phase 2, and the block's
    shared memory."""
    assert chain.wavefront_mma_fits(dils, tile) == fits
    smem = chain.wavefront_mma_smem_bytes(dils, tile)
    assert smem == 4 * 128 * 128 * 2 + 2 * (tile + 2 * sum(dils) + 16) * 256
    if dils == (8, 9, 1):
        assert smem <= chain.SMEM_PER_BLOCK


def test_plan_needs_the_tile_to_divide_the_clip():
    assert all(g.splits is None for g in chain.plan_bwd_groups((1, 2, 4), 100, 4))
    assert all(g.splits is None for g in chain.plan_bwd_groups((1, 2, 4), 192, 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dils,tile,missing", [((1, 2, 4, 8), 64, (2,)), ((1, 2, 4, 8), 32, ()),
                                               ((1, 2, 4), 64, (0, 1, 2)), ((2, 4), 64, (1,)),
                                               ((1, 2, 4, 8), 128, (2,)), ((8, 4, 2, 1), 128, ()),
                                               ((1, 2, 4), 128, (0, 1, 2)), ((2, 4), 128, (1,))])
def test_group_plain_equals_the_layer_chain_bit_for_bit(dtype, dils, tile, missing):
    """Two clips of 256 rows: the pieces in the kernel's order over a
    three-slot carry give exactly what ``layer_bwd_plain`` gives layer by
    layer (same operands, same float32 products per row, same cast points),
    also at the tensor-core kernel's tile 128, whose splits no dy buffer
    limits."""
    clip = 256
    args = _group_inputs(dils, 2 * clip, 8, dtype, missing=missing)
    want = chain.group_bwd_chain_plain(*args, dils, clip)
    splits = chain.wavefront_splits(dils, tile, None if tile == 128 else chain.WF_DY_ROWS)
    got = chain.group_bwd_plain(*args, dils, clip, tile, splits)
    assert got.dtype == dtype
    assert torch.equal(got, want)


# Valid windows in in-clip rows, for a tile of 64 with dils (1, 2, 4, 8)
# (nk = 15): edges inside tiles; edges inside the halos around the tile
# boundaries 64 and 128; from 0; clamped past both ends; the full range.
GROUP_WINDOWS = [(37, 200), (60, 133), (0, 100), (-9, 300), (0, 256)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("vw", GROUP_WINDOWS)
def test_group_plain_under_a_window_equals_the_windowed_layer_chain(dtype, vw):
    """Two clips of 256 rows: with a window the kernel's schedule (every
    halo row zeroed by its in-clip position) equals ``layer_bwd_plain`` with
    the window layer by layer, bit for bit; the full range equals no window."""
    clip, dils, tile = 256, (1, 2, 4, 8), 64
    args = _group_inputs(dils, 2 * clip, 8, dtype, missing=(1,))
    splits = chain.wavefront_splits(dils, tile)
    got = chain.group_bwd_plain(*args, dils, clip, tile, splits, valid_window=vw)
    assert torch.equal(got, chain.group_bwd_chain_plain(*args, dils, clip, valid_window=vw))
    if max(vw[0], 0) == 0 and min(vw[1], clip) == clip:
        assert torch.equal(got, chain.group_bwd_plain(*args, dils, clip, tile, splits))
    else:
        assert not torch.equal(got, chain.group_bwd_plain(*args, dils, clip, tile, splits))


# Windows for the tensor-core tile of 128 (nk = 15): edges inside a tile, in
# the halos around the tile boundary 128, at 0, clamped, the full range.
MMA_GROUP_WINDOWS = [(37, 200), (120, 137), (0, 130), (-9, 300), (0, 256)]


@pytest.mark.parametrize("vw", MMA_GROUP_WINDOWS)
def test_tensor_core_group_plain_under_a_window_equals_the_windowed_layer_chain(vw):
    """bf16, the bf16 plan's group (1, 2, 4, 8) at tile 128, two clips of 256
    rows: the plain schedule with a window equals ``layer_bwd_plain`` with
    the window layer by layer, bit for bit; the full range equals no window."""
    clip, dils = 256, (1, 2, 4, 8)
    group = chain.plan_bwd_groups(dils, clip, 2)[0]
    assert group.tile == 128
    args = _group_inputs(dils, 2 * clip, 8, torch.bfloat16, missing=(1,), seed=4)
    got = chain.group_bwd(*args, group, clip, vw)
    assert torch.equal(got, chain.group_bwd_chain_plain(*args, dils, clip, valid_window=vw))
    full = max(vw[0], 0) == 0 and min(vw[1], clip) == clip
    assert torch.equal(got, chain.group_bwd(*args, group, clip)) == full


def test_group_bwd_on_the_cpu_runs_the_plain_version_and_counts_no_launch():
    dils, clip = (1, 2, 4, 8), 128
    args = _group_inputs(dils, clip, 8, torch.float32)
    group = chain.plan_bwd_groups(dils, clip, 4)[0]
    _build.reset_launches()
    got = chain.group_bwd(*args, group, clip)
    assert torch.equal(got, chain.group_bwd_chain_plain(*args, dils, clip))
    assert _build.LAUNCHES["K2wf"] == 0
    with pytest.raises(ValueError, match="planned group"):
        chain.group_bwd(*args, chain.BwdGroup(0, dils), clip)


def test_group_bwd_never_falls_back_on_other_devices():
    dils, clip = (1, 2), 64
    x = torch.zeros((clip, chain.WIDTH), device="meta")
    m = torch.zeros((clip, chain.WIDTH), dtype=torch.uint8, device="meta")
    w3 = torch.zeros((2, 3, chain.WIDTH, chain.WIDTH), device="meta")
    w = torch.zeros((2, chain.WIDTH, chain.WIDTH), device="meta")
    group = chain.plan_bwd_groups(dils, clip, 4)[0]
    with pytest.raises(RuntimeError, match="CUDA"):
        chain.group_bwd(x, [None, None], [m, m], m, w3, w, group, clip)


def _trunk_grad(dils, emit, x, wd, bd, wr, br, cts):
    xt = t(x).requires_grad_(True)
    taps = chain.fused_trunk(xt, t(wd), t(bd), t(wr), t(br), dils, emit)
    (g,) = torch.autograd.grad(taps, xt, [t(c) for c in cts])
    return g


@pytest.mark.usefixtures("interpret_mode", "jax_wavefront")
def test_trunk_gradient_with_the_switch_on_matches_jax_wavefront(monkeypatch):
    """dils (1, 2, 4), T=256, C=8, as the JAX package's own wavefront test:
    rtol 1e-5 / atol 1e-4, the tolerance that test holds itself to (float32
    products summed in different orders, gradients of order 10)."""
    dils, emit = (1, 2, 4), (1, 2)
    plans = jchain.plan_groups(dils, 256, 8, 4, emit)
    assert any(jchain._wavefront_splits(p) is not None for p in plans)
    x, wd, bd, wr, br = trunk_inputs(t=256, c=8, n=3, seed=5)
    tg = [np.random.RandomState(9 + i).randn(256, 8).astype(np.float32) for i in range(2)]

    def jloss(z):
        taps = jchain.fused_trunk(z, wd, bd, wr, br, dils, emit)
        return sum(jnp.sum((tp - g) ** 2) * (i + 1) for i, (tp, g) in enumerate(zip(taps, tg)))

    want = jax.grad(jloss)(jnp.asarray(x))

    def torch_grad():
        xt = t(x).requires_grad_(True)
        taps = chain.fused_trunk(xt, t(wd), t(bd), t(wr), t(br), dils, emit)
        loss = sum(torch.sum((tp - t(g)) ** 2) * (i + 1)
                   for i, (tp, g) in enumerate(zip(taps, tg)))
        return torch.autograd.grad(loss, xt)[0]

    serial = torch_grad()
    monkeypatch.setattr(chain, "_BWD_WAVEFRONT", True)
    calls = []
    plain = chain.group_bwd_plain
    monkeypatch.setattr(chain, "group_bwd_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    got = torch_grad()
    assert calls == [1], "the three layers must run as one wavefront group"
    np.testing.assert_allclose(n(got), n(want), rtol=1e-5, atol=1e-4)
    assert torch.equal(got, serial)


@pytest.mark.usefixtures("interpret_mode", "jax_wavefront")
@pytest.mark.parametrize("vw", [(37, 200), (60, 133), (0, 256)],
                         ids=["cuts a tile", "cuts the halos", "full range"])
def test_windowed_trunk_gradient_with_the_switch_on_matches_jax_wavefront(vw, monkeypatch):
    """dils (1, 2, 4), T=256, C=8: the windowed trunk's gradient with both
    packages' wavefront on (JAX: the windowed branch of
    ``_bwd_group_kernel_wf``, Pallas in interpret mode) at rtol 1e-5 / atol
    1e-4 as above; bit for bit the port's serial windowed gradient, and with
    the full range its unwindowed one."""
    dils, emit = (1, 2, 4), (1, 2)
    x, wd, bd, wr, br = trunk_inputs(t=256, c=8, n=3, seed=6)
    cts = [np.random.RandomState(19 + i).randn(256, 8).astype(np.float32) for i in range(2)]
    jvw = jnp.asarray(vw, jnp.int32)

    def jloss(z):
        taps = jchain.fused_trunk(z, wd, bd, wr, br, dils, emit, valid_window=jvw)
        return sum(jnp.sum(tp * c) for tp, c in zip(taps, cts))

    want = jax.grad(jloss)(jnp.asarray(x))

    def torch_grad(window):
        xt = t(x).requires_grad_(True)
        taps = chain.fused_trunk(xt, t(wd), t(bd), t(wr), t(br), dils, emit,
                                 valid_window=window)
        return torch.autograd.grad(taps, xt, [t(c) for c in cts])[0]

    serial = torch_grad(vw)
    monkeypatch.setattr(chain, "_BWD_WAVEFRONT", True)
    calls = []
    plain = chain.group_bwd_plain
    monkeypatch.setattr(chain, "group_bwd_plain", lambda *a: calls.append(a[10]) or plain(*a))
    got = torch_grad(vw)
    assert calls == [vw], "the three layers must run as one wavefront group with the window"
    np.testing.assert_allclose(n(got), n(want), rtol=1e-5, atol=1e-4)
    assert torch.equal(got, serial)
    if vw == (0, 256):
        assert torch.equal(got, torch_grad(None))


# bf16 against JAX's bf16: the same cast points; the float32 sums run in
# other orders, so a value may round to the neighbouring bf16 number. Held
# to one bf16 ulp of the largest entry (2^-7 of it); measured bit-equal.
BF16_ULP = 2.0 ** -7


@pytest.mark.usefixtures("interpret_mode", "jax_wavefront")
@pytest.mark.parametrize("vw", [None, (37, 200), (120, 137), (0, 256)],
                         ids=["no window", "cuts a tile", "cuts the halos", "full range"])
def test_bf16_trunk_gradient_with_the_switch_on_matches_jax_wavefront(vw, monkeypatch):
    """dils (1, 2, 4), T=256, C=8, taps 1 and 2, bfloat16: the trunk's
    waveform gradient with both packages' wavefront on (JAX:
    ``_bwd_group_kernel_wf`` in bf16, Pallas in interpret mode, its windowed
    branch with a window; the port: the bf16 plan's tile 128, the
    tensor-core K2-wf's schedule on the CPU, a tile boundary at 128 in the
    clip) at BF16_ULP; the port's bit for bit its serial backward, and with
    the full range its unwindowed gradient."""
    dils, emit = (1, 2, 4), (1, 2)
    plans = jchain.plan_groups(dils, 256, 8, 2, emit)
    assert any(jchain._wavefront_splits(p) is not None for p in plans)
    assert chain.plan_bwd_groups(dils, 256, 2)[0].tile == 128
    x, wd, bd, wr, br = trunk_inputs(t=256, c=8, n=3, seed=7)
    cts = [np.random.RandomState(21 + i).randn(256, 8).astype(np.float32) for i in range(2)]
    bf, jbf = torch.bfloat16, jnp.bfloat16
    jvw = None if vw is None else jnp.asarray(vw, jnp.int32)

    def jtaps(z):
        return jchain.fused_trunk(z, *(jnp.asarray(a, jbf) for a in (wd, bd, wr, br)), dils,
                                  emit, valid_window=jvw)

    _, vjp = jax.vjp(jtaps, jnp.asarray(x, jbf))
    (want,) = vjp(tuple(jnp.asarray(c, jbf) for c in cts))

    def torch_grad(window):
        xt = t(x, bf).requires_grad_(True)
        taps = chain.fused_trunk(xt, *(t(a, bf) for a in (wd, bd, wr, br)), dils, emit,
                                 valid_window=window)
        return torch.autograd.grad(taps, xt, [t(c, bf) for c in cts])[0]

    serial = torch_grad(vw)
    monkeypatch.setattr(chain, "_BWD_WAVEFRONT", True)
    calls = []
    plain = chain.group_bwd_plain
    monkeypatch.setattr(chain, "group_bwd_plain", lambda *a: calls.append(a[10]) or plain(*a))
    got = torch_grad(vw)
    assert calls == [vw], "the three layers must run as one wavefront group"
    assert got.dtype == bf and torch.equal(got, serial)
    if vw == (0, 256):
        assert torch.equal(got, torch_grad(None))
    assert np.abs(n(got) - n(want)).max() <= BF16_ULP * np.abs(n(want)).max()


def test_infeasible_group_routes_to_the_single_layer_path(port_wavefront, monkeypatch):
    """dils (16, 32, 256): no run of layers is feasible, so with the switch on
    every layer still goes through ``layer_bwd`` and the result is unchanged."""
    dils, emit = (16, 32, 256), (0, 2)
    assert all(g.splits is None for g in chain.plan_bwd_groups(dils, 512, 4))
    x, wd, bd, wr, br = trunk_inputs(t=512, c=8, n=3, seed=3)
    cts = [np.random.RandomState(4 + i).randn(512, 8).astype(np.float32) for i in range(2)]
    calls = []
    single = chain.layer_bwd
    monkeypatch.setattr(chain, "layer_bwd", lambda *a, **k: calls.append(1) or single(*a, **k))
    monkeypatch.setattr(chain, "group_bwd", functools.partial(pytest.fail, "grouped"))
    got = _trunk_grad(dils, emit, x, wd, bd, wr, br, cts)
    assert len(calls) == 3
    monkeypatch.setattr(chain, "_BWD_WAVEFRONT", False)
    assert torch.equal(got, _trunk_grad(dils, emit, x, wd, bd, wr, br, cts))


def test_mixed_plan_matches_the_serial_backward(port_wavefront, monkeypatch):
    """dils (1, 2, 4, 8, 256) with taps inside and outside the group: one
    group plus one single layer equals five single layers, bit for bit."""
    dils, emit = (1, 2, 4, 8, 256), (1, 3, 4)
    plan = chain.plan_bwd_groups(dils, 512, 4)
    assert [len(g.dils) for g in plan] == [4, 1]
    x, wd, bd, wr, br = trunk_inputs()
    cts = [np.random.RandomState(7 + i).randn(*x.shape).astype(np.float32) for i in range(3)]
    got = _trunk_grad(dils, emit, x, wd, bd, wr, br, cts)
    monkeypatch.setattr(chain, "_BWD_WAVEFRONT", False)
    assert torch.equal(got, _trunk_grad(dils, emit, x, wd, bd, wr, br, cts))


def test_switch_is_off_by_default_and_read_from_the_environment():
    import os
    import subprocess
    import sys

    code = ("from audio_style_transfer_tpu_torch.ops import chain; "
            "print(chain._BWD_WAVEFRONT)")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for value, want in ((None, "False"), ("1", "True")):
        env = dict(os.environ, PYTHONPATH=repo)
        env.pop("AST_CHAIN_BWD_WAVEFRONT", None)
        if value is not None:
            env["AST_CHAIN_BWD_WAVEFRONT"] = value
        r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                           text=True, timeout=120)
        assert r.stdout.strip() == want, r.stderr[-1000:]
