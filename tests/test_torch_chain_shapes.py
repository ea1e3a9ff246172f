"""The trunk layer's semantics at tile and clip edges, pinned on the CPU, and
the C entry points' signatures.

The bfloat16 trunk kernels work on tiles of 64 rows (K1, K2) and 128 rows
(K7b's phase 1, K2-wf), so three flattened clips of 96 rows (288 rows: no
multiple of either tile, clip edges inside tiles) with dilations below, at
and above the clip length are the shapes where a tile kernel can go wrong. Here the plain versions of K1 and K2
(which the card tests hold the kernels to) are held to the JAX
``reference_trunk`` and its ``jax.vjp`` at exactly those shapes.

The kernels are called through ctypes, which passes an argument list that
disagrees with the C declaration without complaint (a pointer declared as
int is cut to 32 bits), so the ``extern "C"`` declarations of every
csrc/*.cu are parsed and held against ``ops/_build.py::_SIGNATURES``.
"""

import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_helpers import n

from audio_style_transfer_tpu.ops import pallas_chain as jchain
from audio_style_transfer_tpu.ops.conv import conv1d as jconv1d
from audio_style_transfer_tpu_torch.ops import _build, chain

C, CLIP, CLIPS = 16, 96, 3
DILATIONS = (1, 7, 96, 128)
ULP = 2.0 ** -7  # one bfloat16 ulp of a value, at most


def _inputs(d, dtype):
    """x and cotangents [CLIPS, CLIP, C] and one layer's weights, as float32
    numpy arrays holding values of ``dtype`` (the biases stay float32)."""
    rng = np.random.RandomState(d)
    arrs = dict(x=rng.randn(CLIPS, CLIP, C), ct=rng.randn(CLIPS, CLIP, C),
                dtap=rng.randn(CLIPS, CLIP, C), wd=rng.randn(3, C, C) * 0.2,
                wr=rng.randn(C, C) * 0.2)
    out = {k: torch.tensor(v, dtype=torch.float32).to(dtype).float().numpy()
           for k, v in arrs.items()}
    out["bd"] = (rng.randn(C) * 0.1).astype(np.float32)
    out["br"] = (rng.randn(C) * 0.1).astype(np.float32)
    return out


def _jax_layer(a, d):
    """(out, vjp) of the JAX reference layer in float32, clip by clip."""
    def f(x):
        one = lambda z: jchain.reference_trunk(  # noqa: E731
            z, a["wd"][None], a["bd"][None], a["wr"][None], a["br"][None], (d,), (0,))[0]
        return jax.vmap(one)(x)
    return jax.vjp(f, jnp.asarray(a["x"]))


def _close(got, want, dtype):
    """float32: the same float32 products in another order. bfloat16: the
    reference is float32 arithmetic on the same bfloat16 values, so the
    port's roundings (v, z, the sum) may move a result by one bfloat16 ulp
    of the largest value."""
    got, want = n(got).reshape(want.shape), np.asarray(want, np.float32)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(got - want).max() <= ULP * np.abs(want).max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", DILATIONS)
def test_plain_forward_matches_jax_reference_at_tile_and_clip_edges(d, dtype):
    a = _inputs(d, dtype)
    t = lambda k: torch.tensor(a[k]).to(dtype)  # noqa: E731
    out, mask, inmask = chain.layer_fwd_plain(
        t("x").reshape(-1, C), t("wd"), torch.tensor(a["bd"]), t("wr"), torch.tensor(a["br"]),
        d, CLIP, want_inmask=True)
    assert out.dtype == dtype and out.shape == (CLIPS * CLIP, C)
    want, _ = _jax_layer(a, d)
    _close(out, want, dtype)
    # The mask bytes: bit 0 the output's sign, bit 1 the gate y > 0 through
    # the JAX conv (float32 on the same values: no y is within rounding of 0
    # for these seeds), the input mask x > 0.
    y = jconv1d(jnp.maximum(jnp.asarray(a["x"]), 0), a["wd"], a["bd"], dilation=d, causal=False)
    np.testing.assert_array_equal(n(mask & 1), n(out > 0))
    np.testing.assert_array_equal(n((mask >> 1) & 1).reshape(y.shape), n(y > 0))
    np.testing.assert_array_equal(n(inmask).reshape(a["x"].shape), a["x"] > 0)
    # Rows of one clip never read another: each clip alone gives its rows.
    alone, _, _ = chain.layer_fwd_plain(t("x")[1], t("wd"), torch.tensor(a["bd"]), t("wr"),
                                        torch.tensor(a["br"]), d, CLIP)
    assert torch.equal(alone, out[CLIP:2 * CLIP])


@pytest.mark.parametrize("with_dtap", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", DILATIONS)
def test_plain_backward_matches_jax_vjp_at_tile_and_clip_edges(d, dtype, with_dtap):
    a = _inputs(d, dtype)
    t = lambda k: torch.tensor(a[k]).to(dtype)  # noqa: E731
    _, mask, inmask = chain.layer_fwd_plain(
        t("x").reshape(-1, C), t("wd"), torch.tensor(a["bd"]), t("wr"), torch.tensor(a["br"]),
        d, CLIP, want_inmask=True)
    dtap = t("dtap").reshape(-1, C) if with_dtap else None
    dx = chain.layer_bwd_plain(t("ct").reshape(-1, C), dtap, mask, inmask, t("wd"), t("wr"),
                               d, CLIP)
    assert dx.dtype == dtype
    _, vjp = _jax_layer(a, d)
    # The layer's output cotangent is g = round(dxn + dtap); the reference
    # gets the same g.
    g = (t("ct") + t("dtap")).float().numpy() if with_dtap else a["ct"]
    (want,) = vjp(jnp.asarray(g))
    _close(dx, want, dtype)


def _c_entries():
    """name -> 'P'/'I' per argument of every `int ast_*(...)` in the
    extern "C" blocks of csrc/*.cu."""
    entries = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        text = src.read_text()
        for block in re.findall(r'extern "C" \{(.*?)\n\}  // extern "C"', text, re.S):
            for name, args in re.findall(r"\bint (ast_\w+)\(([^)]*)\)\s*\{", block):
                assert name not in entries, f"{name} is defined twice"
                kinds = []
                for arg in args.split(","):
                    arg = " ".join(arg.split())
                    if "*" in arg:
                        kinds.append("P")
                    else:
                        assert re.fullmatch(r"int \w+", arg), f"{name}: argument {arg!r}"
                        kinds.append("I")
                entries[name] = "".join(kinds)
    return entries


def _ctypes_kind(tp) -> str:
    if tp is ctypes.c_int:
        return "I"
    assert tp is ctypes.c_void_p or issubclass(tp, ctypes._Pointer), tp
    return "P"


def test_every_c_entry_point_is_registered_and_none_is_missing():
    entries = _c_entries()
    assert set(entries) == set(_build._SIGNATURES)
    assert {"ast_trunk_fwd_mma", "ast_trunk_bwd_mma", "ast_trunk_fwd", "ast_trunk_bwd"} <= set(
        entries)


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_c_entry_point_arguments_match_the_ctypes_signature(name):
    got = "".join(_ctypes_kind(tp) for tp in _build._SIGNATURES[name])
    assert got == _c_entries()[name]
    assert got.endswith("P")  # the stream comes last


def test_the_tensor_core_entries_take_the_fma_entries_arguments_without_is_bf16():
    """Each trunk kernel has one build per dtype: the float32 FMA entry takes
    exactly the bfloat16 tensor-core entry's arguments, with no dtype flag."""
    entries = _c_entries()
    for fma in ("ast_trunk_fwd", "ast_trunk_bwd", "ast_encoder_fwd", "ast_encoder_bwd"):
        assert entries[fma] == entries[fma + "_mma"]
    # The grouped backward: the FMA build takes its planned splits beside the
    # tensor-core build's arguments.
    group, group_mma = entries["ast_trunk_bwd_group"], entries["ast_trunk_bwd_group_mma"]
    assert group == group_mma[:8] + "P" + group_mma[8:]
